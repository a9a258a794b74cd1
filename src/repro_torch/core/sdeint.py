"""Batched Monte-Carlo SDE integration: one call, many trajectories.

Port of the fixed-grid half of ``repro.core.sdeint``.  ``sdeint`` owns the
plumbing above the solver layer — Brownian-driver construction, solver
resolution by registry name, and the path batch — and delegates the
integration to :func:`repro_torch.core.adjoint.solve`.

Batching is *by key*, as in the reference: path ``i`` draws its own
counter-based Brownian path from its own key, so a batch gives the same
paths as a loop of single-trajectory calls over the same keys.  Where the
reference vmaps a single-path solve, the port runs one solve over a state
with the batch written out as a leading axis (``y0`` is shared and
broadcast); the drift and diffusion therefore see batched states.

``sdeint_ticks`` runs a ``(T, B, 2)`` stack of per-tick key batches, tick by
tick, each exactly one ``sdeint`` batch; with ``active_steps`` and
``step_size`` it runs the padded bucketed mode of the serving executor, in
which tick ``t`` integrates ``active_steps[t]`` steps of the exact size
``step_size`` and so equals the unpadded solve of that horizon.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ..device import not_yet_ported, resolve_device
from . import prng
from .adjoint import SolveResult, solve
from .brownian import brownian_path, padded_brownian_path
from .grid import TimeGrid
from .pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .registry import get_solver

__all__ = ["sdeint", "sdeint_ticks", "path_keys"]


def path_keys(key: torch.Tensor, n_paths: int) -> torch.Tensor:
    """Per-path key batch ``fold_in(key, i)``, ``i < n_paths`` — the
    path-batching convention shared with the reference: a request seed
    names the same trajectories in both packages."""
    idx = torch.arange(int(n_paths), dtype=torch.int64, device=key.device)
    return prng.fold_in(key, idx)


def _infer_noise_shape(term, y0):
    """Default Brownian-increment shape from the term's noise structure."""
    noise = getattr(term, "noise", "diagonal")
    if noise == "none":
        return ()
    if noise == "general":
        raise ValueError(
            "noise='general' needs an explicit noise_shape=(..., m) — the "
            "number of driving channels is not derivable from the state"
        )
    if noise == "scalar":
        return ()
    leaves, treedef = tree_flatten(y0)
    return tree_unflatten(treedef, [tuple(l.shape) for l in leaves])


def _infer_dtype(y0):
    for leaf in tree_leaves(y0):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf.dtype
    return torch.float32


def _check_options(solver, adjoint, adaptive, save_every, save_at, rtol, atol,
                   h0, bm_tol, bounded):
    """The reference's option validation; adaptive solves are not ported."""
    adaptive = adaptive or getattr(solver, "adaptive", False)
    if adjoint not in ("full", "recursive", "reversible"):
        raise ValueError(f"unknown adjoint {adjoint!r}")
    if adaptive and not bounded and adjoint != "full":
        raise ValueError(
            f"bounded=False (single controller pass) is forward-only and "
            f"cannot host the {adjoint!r} adjoint; use bounded=True "
            "(realize-then-solve) for gradients"
        )
    if adaptive and save_every is not None:
        raise ValueError(
            "save_every indexes a fixed grid; with adaptive=True pass "
            "save_at=<array of times> instead"
        )
    if save_at is not None and not adaptive:
        raise ValueError(
            "save_at (arbitrary-time dense output) requires adaptive=True / "
            "an ':adaptive' solver spec; on a fixed grid use save_every"
        )
    if not adaptive:
        for opt_name, bad in (("rtol", rtol is not None),
                              ("atol", atol is not None),
                              ("h0", h0 is not None),
                              ("bm_tol", bm_tol is not None),
                              ("bounded", bounded is not True)):
            if bad:
                raise ValueError(
                    f"{opt_name} only applies to adaptive solves; pass "
                    "adaptive=True or an ':adaptive' solver spec — a "
                    "tolerance request must not silently run a fixed grid"
                )
    if adaptive:
        raise not_yet_ported("adaptive solves (':adaptive' specs)")


def _batched_y0(y0, batch, device):
    """``y0`` on ``device``, broadcast to a dense leading ``batch``."""
    def leaf(x):
        x = torch.as_tensor(x, device=device)
        return x.expand(tuple(batch) + tuple(x.shape)).contiguous()

    return tree_map(leaf, y0)


def _trajectory_fn(term, solver, t0, t1, n_steps, y0, device, *, args=None,
                   adjoint="full", save_every=None, remat_chunk=None,
                   adaptive=False, save_at=None, rtol=None, atol=None, h0=None,
                   bm_tol=None, bounded=True, bulk_increments=True, guard=None,
                   noise_shape=None, dtype=None, step_size=None):
    """Validate options and build the ``(keys, n_active) -> result`` solve
    over a batch of keys (``(*batch, 2)``).  With ``step_size`` the grid is
    padded: ``n_steps`` steps of exact size ``step_size``, ``n_active``
    live; otherwise ``n_active`` is ignored."""
    solver = get_solver(solver)
    _check_options(solver, adjoint, adaptive, save_every, save_at, rtol, atol,
                   h0, bm_tol, bounded)
    if noise_shape is None:
        noise_shape = _infer_noise_shape(term, y0)
    if dtype is None:
        dtype = _infer_dtype(y0)
    ode = getattr(term, "noise", "diagonal") == "none"

    def one(keys: torch.Tensor, n_active: Optional[int] = None):
        batch = tuple(keys.shape[:-1])
        if step_size is None:
            driver = None if ode else brownian_path(
                keys, t0, t1, n_steps, shape=noise_shape, dtype=dtype)
            grid = TimeGrid.uniform(t0, t1, n_steps, driver, dtype=dtype,
                                    device=keys.device)
        else:
            driver = None if ode else padded_brownian_path(
                keys, t0, step_size, n_steps, shape=noise_shape, dtype=dtype)
            grid = TimeGrid.padded_uniform(t0, step_size, n_active, n_steps,
                                           driver, dtype=dtype,
                                           device=keys.device)
        out = solve(solver, term, _batched_y0(y0, batch, keys.device), grid,
                    args, adjoint=adjoint, save_every=save_every,
                    remat_chunk=remat_chunk, bulk_increments=bulk_increments,
                    guard=guard, batch_dims=len(batch))
        if out.ys is not None and batch:
            # solve stacks saves first; sdeint's layout is (*batch, n_saves, ...)
            out = out._replace(ys=tree_map(lambda x: x.movedim(0, len(batch)),
                                           out.ys))
        return out

    return one


def sdeint(
    term,
    solver,
    t0: float,
    t1: float,
    n_steps: int,
    y0,
    key: Optional[torch.Tensor] = None,
    *,
    args: Any = None,
    adjoint: str = "full",
    save_every: Optional[int] = None,
    remat_chunk: Optional[int] = None,
    adaptive: bool = False,
    save_at=None,
    rtol: Optional[float] = None,
    atol: Optional[float] = None,
    h0: Optional[float] = None,
    bm_tol: Optional[float] = None,
    bounded: bool = True,
    bulk_increments: bool = True,
    guard: Optional[float] = None,
    noise_shape=None,
    dtype=None,
    batch_keys: Optional[torch.Tensor] = None,
    mesh=None,
    mesh_axis: Optional[str] = None,
    device=None,
) -> SolveResult:
    """Integrate ``term`` over ``[t0, t1]`` on a fixed grid of ``n_steps``.

    Arguments are the reference's (``repro.core.sdeint.sdeint``): ``key`` is
    one ``(2,)`` key for a single trajectory; ``batch_keys`` a ``(B, 2)``
    stack of per-path keys (see :func:`path_keys`), giving results with a
    leading ``B`` axis (``ys`` is ``(B, n_saves, ...)``, ``diverged``
    ``(B,)``).  ``device`` (default ``"cuda"``) is where the solve runs;
    keys and ``y0`` are moved there, ``args`` (e.g. an ``nn.Module``) must
    already live there.  ``adjoint`` is ``"full"`` or ``"reversible"``
    (O(1) memory in the trajectory; the parameters of an ``nn.Module``
    ``args`` get their gradients through it).  Adaptive solves,
    ``save_at``, the recursive adjoint and mesh fan-out are not ported yet
    and raise.
    """
    device = resolve_device(device)
    one = _trajectory_fn(
        term, solver, t0, t1, n_steps, y0, device, args=args, adjoint=adjoint,
        save_every=save_every, remat_chunk=remat_chunk, adaptive=adaptive,
        save_at=save_at, rtol=rtol, atol=atol, h0=h0, bm_tol=bm_tol,
        bounded=bounded, bulk_increments=bulk_increments, guard=guard,
        noise_shape=noise_shape, dtype=dtype,
    )
    if batch_keys is None:
        if mesh_axis is not None or mesh is not None:
            raise ValueError("mesh fan-out requires batch_keys")
        if key is None:
            raise ValueError("pass key= for a single trajectory or batch_keys= for a batch")
        return one(key.to(device))
    if mesh_axis is not None or mesh is not None:
        raise not_yet_ported("mesh fan-out (mesh/mesh_axis)")
    return one(batch_keys.to(device))


def _stack_ticks(outs):
    """Per-tick results stacked on a leading tick axis (None stays None)."""
    def field(vals):
        if vals[0] is None:
            return None
        return tree_map(lambda *xs: torch.stack(xs), vals[0], *vals[1:])

    return SolveResult(*(field([o[i] for o in outs])
                         for i in range(len(SolveResult._fields))))


def sdeint_ticks(
    term,
    solver,
    t0: float,
    t1: float,
    n_steps: int,
    y0,
    tick_keys: torch.Tensor,
    *,
    mesh=None,
    mesh_axis: Optional[str] = None,
    active_steps: Optional[Sequence[int]] = None,
    step_size: Optional[float] = None,
    device=None,
    **kwargs,
) -> SolveResult:
    """Integrate a ``(T, B, 2)`` stack of key batches, tick by tick.

    Every result leaf gains leading ``(T, B)`` axes; tick ``t`` equals
    ``sdeint(..., batch_keys=tick_keys[t])``.  Padded bucketed mode
    (``active_steps`` + ``step_size``): ``n_steps`` is the padded grid
    length, ``step_size`` the exact step ``h`` every tick shares and
    ``active_steps`` the ``T`` live step counts as host integers; tick ``t``
    equals ``sdeint(term, solver, t0, t0 + active_steps[t]*h,
    active_steps[t], ...)`` over the same keys, and only live steps run.
    Other keyword arguments are as for :func:`sdeint`.
    """
    if tick_keys.dim() < 3:
        raise ValueError(
            f"tick_keys must stack per-tick key batches — expected a "
            f"(n_ticks, batch, ...) key array, got shape {tuple(tick_keys.shape)} "
            f"(dtype {tick_keys.dtype}); for a single flat batch call "
            "sdeint(..., batch_keys=keys)"
        )
    if mesh_axis is not None or mesh is not None:
        raise not_yet_ported("mesh fan-out (mesh/mesh_axis)")
    device = resolve_device(device)
    tick_keys = tick_keys.to(device)
    n_ticks = tick_keys.shape[0]
    if active_steps is not None:
        if step_size is None:
            raise ValueError(
                "active_steps (padded bucketed dispatch) requires step_size "
                "— the bucket's exact static step h shared by every tick"
            )
        active = [int(a) for a in active_steps]
        if len(active) != n_ticks:
            raise ValueError(
                f"active_steps must be a (n_ticks,) = ({n_ticks},) "
                f"int array (one live-step count per tick), got shape "
                f"({len(active)},)"
            )
        if kwargs.get("save_every") is not None or kwargs.get("save_at") is not None:
            raise ValueError(
                "padded bucketed dispatch carries no saved trajectories; "
                "save_every/save_at requests must dispatch exact"
            )
        one = _trajectory_fn(term, solver, t0, t0 + n_steps * step_size,
                             n_steps, y0, device, step_size=float(step_size),
                             **kwargs)
        return _stack_ticks([one(tick_keys[t], active[t])
                             for t in range(n_ticks)])
    if step_size is not None:
        raise ValueError("step_size only applies with active_steps (padded "
                         "bucketed dispatch)")
    one = _trajectory_fn(term, solver, t0, t1, n_steps, y0, device, **kwargs)
    return _stack_ticks([one(tick_keys[t]) for t in range(n_ticks)])
