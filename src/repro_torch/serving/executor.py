"""Device-side serving executor: one callable per signature and stack depth.

Port of ``repro.serving.executor``.  The executor knows nothing about
requests or queues: its unit of work is a **tick stack** — a
``(n_ticks, slots, 2)`` tensor of per-path keys on the device, every tick
sharing one request signature or one padded bucket — which it runs through
:func:`repro_torch.core.sdeint_ticks`.  ``n_dispatches`` / ``n_ticks`` count
host round trips and the ticks they served.

There is no jit and no buffer donation: PyTorch runs eagerly, so the cached
callable per ``(signature-or-BucketKey, n_ticks)`` only closes over the
solve's configuration.  A dispatch enqueues device work and returns device
tensors without synchronising with the host (bucket live-step counts are
host integers from the plan), so the engine can plan the next stack while
the device integrates this one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..core.registry import parse_solver_spec
from ..core.sdeint import sdeint_ticks
from ..device import not_yet_ported, resolve_device
from .bucketing import BucketKey

__all__ = ["TickExecutor"]


class TickExecutor:
    """Run same-signature tick stacks for one SDE term on one device.

    ``term``/``y0``/``args`` define the process; ``guard`` is the in-loop
    blow-up threshold every solve carries (None: no guard); ``device``
    (default ``"cuda"``) is where the solves run.
    """

    def __init__(self, term, y0, *, args: Any = None, noise_shape=None,
                 dtype: Any = torch.float32, mesh=None,
                 mesh_axis: Optional[str] = None,
                 guard: Optional[float] = None, device=None):
        if (mesh is None) != (mesh_axis is None):
            raise ValueError(
                "sharded dispatch needs mesh and mesh_axis together; got "
                f"mesh={'set' if mesh is not None else 'None'}, "
                f"mesh_axis={mesh_axis!r}"
            )
        if mesh is not None:
            raise not_yet_ported("sharded dispatch (mesh/mesh_axis)")
        self.term = term
        self.y0 = y0
        self.args = args
        self.noise_shape = noise_shape
        self.dtype = dtype
        self.guard = guard
        self.device = resolve_device(device)
        self._callables: Dict[Tuple, Callable] = {}
        self.n_dispatches = 0
        self.n_ticks = 0

    def _stack_fn(self, key: Union[Tuple, BucketKey], n_ticks: int) -> Callable:
        """The cached dispatch callable for ``(key, n_ticks)``: ``key`` is an
        exact request signature or a :class:`BucketKey`, whose callable takes
        the ticks' live step counts as its second argument."""
        cache_key = (key, n_ticks)
        if cache_key not in self._callables:
            common = dict(args=self.args, noise_shape=self.noise_shape,
                          dtype=self.dtype, guard=self.guard,
                          device=self.device)
            if isinstance(key, BucketKey):
                bk = key

                def stack(tick_keys, active_steps):
                    return sdeint_ticks(
                        self.term, bk.solver, bk.t0,
                        bk.t0 + bk.n_padded * bk.h, bk.n_padded, self.y0,
                        tick_keys, active_steps=active_steps,
                        step_size=bk.h, **common)
            else:
                solver, t0, t1, n_steps, save_every, rtol, atol, save_at = key
                if (parse_solver_spec(solver)[1].get("adaptive", False)
                        or rtol is not None or atol is not None
                        or save_at is not None):
                    raise not_yet_ported("adaptive serving requests")

                def stack(tick_keys):
                    return sdeint_ticks(
                        self.term, solver, t0, t1, n_steps, self.y0,
                        tick_keys, save_every=save_every, **common)

            self._callables[cache_key] = stack
        return self._callables[cache_key]

    def has_compiled(self, key: Union[Tuple, BucketKey], n_ticks: int) -> bool:
        """Whether ``(key, n_ticks)`` already has its cached callable."""
        return (key, n_ticks) in self._callables

    def dispatch(self, key: Union[Tuple, BucketKey], tick_keys: torch.Tensor,
                 active_steps: Optional[Sequence[int]] = None):
        """Run a ``(n_ticks, slots, 2)`` key stack; one host round trip.

        For a :class:`BucketKey`, ``active_steps`` gives each tick's live
        step count (host integers).  Returns the solve result with leading
        ``(n_ticks, slots)`` axes on every leaf, still on the device.
        """
        n_ticks = tick_keys.shape[0]
        fn = self._stack_fn(key, n_ticks)
        if isinstance(key, BucketKey):
            if active_steps is None:
                raise ValueError("bucketed dispatch needs active_steps")
            out = fn(tick_keys, active_steps)
        else:
            out = fn(tick_keys)
        self.n_dispatches += 1
        self.n_ticks += n_ticks
        return out
