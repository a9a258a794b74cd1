"""Device-side serving executor: one callable per signature and stack depth.

Port of ``repro.serving.executor``.  The executor knows nothing about
requests or queues: its unit of work is a **tick stack** — a
``(n_ticks, slots, 2)`` tensor of per-path keys on the device, every tick
sharing one request signature or one padded bucket — which it runs through
:func:`repro_torch.core.sdeint_ticks`.  ``n_dispatches`` / ``n_ticks`` count
host round trips and the ticks they served.  Adaptive requests dispatch as
one forward-only controller pass (``bounded=False``), as in the reference.

There is no jit and no buffer donation: PyTorch runs eagerly, so the cached
callable per ``(signature-or-BucketKey, n_ticks)`` only closes over the
solve's configuration.  A dispatch enqueues device work and returns device
tensors without synchronising with the host (bucket live-step counts are
host integers from the plan), so the engine can plan the next stack while
the device integrates this one.

What XLA compilation is to the reference — the stall a first dispatch pays,
which ``warmup`` moves ahead of traffic and the persistent compilation cache
carries across processes — is here the ``nvcc`` build of the kernel
libraries a ``use_kernels`` spec launches: :meth:`TickExecutor.warmup`
builds them, and :func:`enable_persistent_compile_cache` keeps them in a
directory a later process loads them from.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..core.registry import get_solver, parse_solver_spec
from ..core.sdeint import sdeint_ticks
from ..core.solvers import ButcherSolver, LowStorageSolver, MCFSolver, Milstein, ReversibleHeun
from ..device import resolve_device
from ..kernels import _build
from ..kernels.sde_step import sde_step as _sk
from ..kernels.williamson2n.williamson2n import KERNEL as _WILLIAMSON2N
from .bucketing import BucketKey

__all__ = ["TickExecutor", "enable_persistent_compile_cache", "spec_kernels"]


def enable_persistent_compile_cache(path: str) -> None:
    """Keep the port's compiled kernel libraries in ``path``.

    The counterpart of the reference's jax persistent compilation cache:
    every kernel library not yet loaded in this process is built into (and
    loaded from) ``path``, named by a hash of its sources and flags, so a
    later process pointed at the same directory loads it and runs no
    ``nvcc`` — a restarted engine warm-starts."""
    _build.set_library_dir(path)


# Kernels by (effective noise) for the increment and the fused 2N stage.
_INCREMENT = {"diagonal": _sk.INCREMENT_DIAG, "general": _sk.INCREMENT_GENERAL,
              "prediffused": _sk.INCREMENT_PRE}
_STAGE = {"diagonal": _sk.WS_STAGE_DIAG, "general": _sk.WS_STAGE_GENERAL,
          "prediffused": _sk.WS_STAGE_PRE}


def spec_kernels(spec: str, noise: str) -> Tuple[_build.CudaKernel, ...]:
    """The CUDA kernels a forward solve with ``spec`` launches on a term of
    declared ``noise`` (``()`` unless the spec sets ``use_kernels``).

    Mirrors the solvers' routing (``core/solvers.py``) under the serving
    solve (full adjoint, bulk increments): an additive term takes the
    prediffused route unless the solver reads the diffusion itself
    (Milstein); EES stages fuse diagonal, general and prediffused noise into
    one stage kernel and run the ``williamson2n`` update otherwise; Butcher
    and MCF schemes add one ``axpy_chain`` per stage combination."""
    solver = get_solver(spec)
    if not getattr(solver, "use_kernels", False):
        return ()
    if noise == "additive":
        noise = ("diagonal" if getattr(solver, "needs_diffusion", False)
                 else "prediffused")
    if isinstance(solver, LowStorageSolver):
        return (_STAGE[noise],) if noise in _STAGE else (_WILLIAMSON2N,)
    inc = (_INCREMENT[noise],) if noise in _INCREMENT else ()
    if isinstance(solver, (ButcherSolver, MCFSolver)):
        return inc + (_sk.AXPY_CHAIN,)
    if isinstance(solver, (ReversibleHeun, Milstein)):
        return inc
    raise NotImplementedError(f"no kernel routing known for {type(solver).__name__}")


class TickExecutor:
    """Run same-signature tick stacks for one SDE term on one device.

    ``term``/``y0``/``args`` define the process; ``guard`` is the in-loop
    blow-up threshold every solve carries (None: no guard); ``device``
    (default ``"cuda"``) is where the solves run.  ``mesh`` + ``mesh_axis``
    (both or neither) shard each tick's slot axis over that mesh axis
    through ``sdeint_ticks``: each rank solves its block of the slots and
    every rank gets the whole tick back.

    :meth:`dispatch` fixes the two pieces of torch state that are
    thread-local, so that it behaves the same from any thread (the async
    engine runs first dispatches in a worker thread):

    * **grad mode** — every dispatch runs under ``torch.no_grad()``: serving
      records no autograd graph, whether or not the model's parameters
      require gradients, and whatever the calling thread's mode;
    * **the CUDA stream** — the executor keeps the stream current where it
      was built (``stream``) and enters it in every dispatch, so the
      kernels (which launch on the current stream), the torch ops around
      them and the ``landing`` event it records after each dispatch share
      one stream.  A caller on another stream is ordered before and after
      the dispatch by stream waits, never by a host sync.
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
        self.term = term
        self.y0 = y0
        self.args = args
        self.noise_shape = noise_shape
        self.dtype = dtype
        self.guard = guard
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.device = resolve_device(device)
        # None off CUDA: every stream operation below is then skipped.
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        # The last event recorded on ``stream`` (by a dispatch, or by a
        # caller after work of its own there): None off CUDA.
        self.landing: Optional[torch.cuda.Event] = None
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
                          device=self.device, mesh=self.mesh,
                          mesh_axis=self.mesh_axis)
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
                extra = {k: v for k, v in (("rtol", rtol), ("atol", atol),
                                           ("save_at", save_at))
                         if v is not None}
                if parse_solver_spec(solver)[1].get("adaptive", False):
                    # Serving is forward-only: one controller pass, which
                    # stops once every path reaches t1 (bitwise equal to
                    # realize-then-solve).
                    extra["bounded"] = False

                def stack(tick_keys):
                    return sdeint_ticks(
                        self.term, solver, t0, t1, n_steps, self.y0,
                        tick_keys, save_every=save_every, **common, **extra)

            self._callables[cache_key] = stack
        return self._callables[cache_key]

    def has_compiled(self, key: Union[Tuple, BucketKey], n_ticks: int) -> bool:
        """Whether ``(key, n_ticks)`` already has its cached callable (False:
        the async engine runs the first dispatch in a worker thread, which
        may pay the kernel libraries' build)."""
        return (key, n_ticks) in self._callables

    def warmup(self, key: Union[Tuple, BucketKey], n_ticks: int,
               slots: int) -> bool:
        """Prepare ``(key, n_ticks)`` ahead of traffic.

        Builds (or loads, from the persistent cache) every kernel library the
        key's solver spec launches on this term — the build a first dispatch
        would otherwise stall on; plain specs and CPU executors build
        nothing — and stores the cached callable.  Runs no device work and
        changes no sample.  ``slots`` is the reference's AOT shape; eager
        callables need none.  Returns True when this call created the
        ``(key, n_ticks)`` entry, False when it existed.
        """
        del slots
        if self.device.type == "cuda":
            solver = key.solver if isinstance(key, BucketKey) else key[0]
            for kernel in spec_kernels(solver, getattr(self.term, "noise",
                                                       "diagonal")):
                kernel.lib()
        fresh = not self.has_compiled(key, n_ticks)
        self._stack_fn(key, n_ticks)
        return fresh

    def record_landing(self) -> Optional[torch.cuda.Event]:
        """Record (and keep as ``landing``) an event on ``stream`` after the
        work enqueued so far; None off CUDA."""
        if self.stream is None:
            return None
        self.landing = torch.cuda.Event()
        self.landing.record(self.stream)
        return self.landing

    @contextlib.contextmanager
    def on_stream(self):
        """Run the body under ``no_grad`` on the executor's stream, ordered
        after the caller's stream and before its later work."""
        with torch.no_grad():
            if self.stream is None:
                yield
                return
            caller = torch.cuda.current_stream(self.device)
            if caller != self.stream:
                self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                yield
            if caller != self.stream:
                caller.wait_stream(self.stream)

    def dispatch(self, key: Union[Tuple, BucketKey], tick_keys: torch.Tensor,
                 active_steps: Optional[Sequence[int]] = None):
        """Run a ``(n_ticks, slots, 2)`` key stack; one host round trip.

        For a :class:`BucketKey`, ``active_steps`` gives each tick's live
        step count (host integers).  Returns the solve result with leading
        ``(n_ticks, slots)`` axes on every leaf, still on the device; its
        work is enqueued on ``stream`` ahead of the ``landing`` event.
        """
        n_ticks = tick_keys.shape[0]
        fn = self._stack_fn(key, n_ticks)
        if isinstance(key, BucketKey) and active_steps is None:
            raise ValueError("bucketed dispatch needs active_steps")
        with self.on_stream():
            if isinstance(key, BucketKey):
                out = fn(tick_keys, active_steps)
            else:
                out = fn(tick_keys)
            self.record_landing()
        self.n_dispatches += 1
        self.n_ticks += n_ticks
        return out
