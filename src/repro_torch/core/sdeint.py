"""Batched Monte-Carlo SDE integration: one call, many trajectories.

Port of ``repro.core.sdeint``.  ``sdeint`` owns the plumbing above the
solver layer — Brownian-driver construction, solver resolution by registry
name, and the path batch — and delegates the integration to
:func:`repro_torch.core.adjoint.solve`.  An adaptive request
(``adaptive=True`` or an ``"ees25:adaptive"`` spec) integrates over one
Virtual Brownian Tree per path key with the PI controller
(:func:`repro_torch.core.adaptive.integrate_adaptive`): realize-then-solve
under any adjoint, or one forward-only pass with ``bounded=False``.

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

``mesh``/``mesh_axis`` fan the batch out over a mesh axis
(:mod:`repro_torch.launch.mesh`), the reference's ``shard_map``: every rank
calls with the same keys, solves its contiguous block of them and
all-gathers every result leaf in rank order, so each rank returns the
whole result — the same as one device's, since a path is a function of its
key alone.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ..device import resolve_device
from . import prng
from .adaptive import integrate_adaptive
from .adjoint import SolveResult, solve
from .brownian import brownian_path, padded_brownian_path, virtual_brownian_tree
from .grid import TimeGrid
from .pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .registry import get_solver

__all__ = ["sdeint", "sdeint_ticks", "path_keys", "tick_solve"]


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
    """The reference's option validation; returns whether the solve is
    adaptive."""
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
    return adaptive


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
    live; otherwise ``n_active`` is ignored.

    The solve carries ``capturable``: True for a fixed or padded grid, whose
    solve reads nothing back on the host (live step counts are host
    integers), so a CUDA graph can capture it; False for an adaptive solve,
    whose controller reads the loop condition on the host between trials."""
    solver = get_solver(solver)
    adaptive = _check_options(solver, adjoint, adaptive, save_every, save_at,
                              rtol, atol, h0, bm_tol, bounded)
    if noise_shape is None:
        noise_shape = _infer_noise_shape(term, y0)
    if dtype is None:
        dtype = _infer_dtype(y0)
    ode = getattr(term, "noise", "diagonal") == "none"
    if adaptive:
        if step_size is not None:
            raise ValueError(
                "active_steps (padded bucketed dispatch) applies to fixed-grid "
                "solves only; adaptive requests must dispatch exact"
            )
        tols = {k: v for k, v in (("rtol", rtol), ("atol", atol)) if v is not None}

        def adaptive_one(keys: torch.Tensor, n_active: Optional[int] = None):
            batch = tuple(keys.shape[:-1])
            vbt = virtual_brownian_tree(keys, t0, t1, shape=noise_shape,
                                        dtype=dtype, tol=bm_tol)
            out = integrate_adaptive(
                solver, term, _batched_y0(y0, batch, keys.device), vbt, args,
                t0=t0, t1=t1, h0=h0, max_steps=int(n_steps), save_at=save_at,
                bounded=bounded, adjoint=adjoint, remat_chunk=remat_chunk,
                bulk_increments=bulk_increments, guard=guard, **tols)
            return _saves_last(out, batch)

        adaptive_one.capturable = False
        return adaptive_one

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
        return _saves_last(out, batch)

    one.capturable = True
    return one


def _fanout(mesh, mesh_axis, n_batch: int):
    """This rank's :class:`~repro_torch.launch.mesh.AxisBlock` for a batch of
    ``n_batch`` sharded over ``mesh_axis`` (``mesh`` defaults to the ambient
    ``with mesh:``), or None without a mesh axis."""
    if mesh_axis is None:
        if mesh is not None:
            raise ValueError("mesh given without mesh_axis; name the axis to shard over")
        return None
    from ..launch.mesh import ambient_mesh, axis_block

    block = axis_block(mesh if mesh is not None else ambient_mesh(), mesh_axis)
    if n_batch % block.world != 0:
        raise ValueError(
            f"mesh axis {mesh_axis!r} of size {block.world} does not divide "
            f"the batch of {n_batch} trajectories"
        )
    return block


def _gathered(out, block, dim: int):
    """Every leaf of a rank's result gathered along its batch axis ``dim``."""
    from ..launch.mesh import gather_blocks

    return tree_map(lambda x: gather_blocks(x, block, dim), out)


def _saves_last(out, batch):
    """solve stacks saves first; sdeint's layout is ``(*batch, n_saves, ...)``."""
    if out.ys is not None and batch:
        out = out._replace(ys=tree_map(lambda x: x.movedim(0, len(batch)),
                                       out.ys))
    return out


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
    already live there.  ``adjoint`` is ``"full"``, ``"recursive"``
    (checkpointed chunks of ``remat_chunk`` steps, default the reference's
    ``isqrt`` rule) or ``"reversible"`` (O(1) memory in the trajectory);
    the parameters of an ``nn.Module`` ``args`` get their gradients through
    each.  Adaptive solves (``adaptive=True`` or an ``":adaptive"`` spec)
    take ``n_steps`` as each path's trial budget, ``rtol``/``atol``/``h0``,
    ``bm_tol`` (the tree's leaf resolution), ``bounded`` and ``save_at``,
    and return an :class:`~repro_torch.core.adaptive.AdaptiveResult` with
    per-path ``t_final``, ``h_final``, ``n_accepted`` and ``n_rejected``
    (``ys`` is ``(B, len(save_at), ...)``).

    ``mesh``/``mesh_axis`` shard the batch over that axis of a
    ``DeviceMesh`` (:func:`~repro_torch.launch.mesh.make_sample_mesh`);
    ``mesh`` defaults to the ambient ``with mesh:`` block, and the axis size
    must divide ``B``.  Every rank passes the same ``batch_keys``, solves its
    contiguous block and returns the whole result, gathered in rank order
    outside autograd (train data-parallel with ``make_sde_train_step(...,
    mesh=...)``, which pulls each rank's share of the gradient back).
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
    block = _fanout(mesh, mesh_axis, batch_keys.shape[0])
    batch_keys = batch_keys.to(device)
    if block is None:
        return one(batch_keys)
    return _gathered(one(batch_keys[block.rows(batch_keys.shape[0])]), block, 0)


def _stack_ticks(outs):
    """Per-tick results (``SolveResult`` or ``AdaptiveResult``) stacked on a
    leading tick axis (None stays None)."""
    def field(vals):
        if vals[0] is None:
            return None
        return tree_map(lambda *xs: torch.stack(xs), vals[0], *vals[1:])

    return type(outs[0])(*(field([o[i] for o in outs])
                           for i in range(len(outs[0]))))


def tick_solve(term, solver, t0: float, t1: float, n_steps: int, y0, *,
               step_size: Optional[float] = None, device=None, **kwargs):
    """The solve :func:`sdeint_ticks` runs on each tick's key batch:
    ``(keys, n_active) -> result``, over the padded grid of ``n_steps``
    steps of ``step_size`` when one is given (``t1`` is then unused).  Its
    ``capturable`` says whether a CUDA graph can capture a tick (see
    ``_trajectory_fn``).  Keyword arguments are as for :func:`sdeint`."""
    device = resolve_device(device)
    if step_size is None:
        return _trajectory_fn(term, solver, t0, t1, n_steps, y0, device, **kwargs)
    return _trajectory_fn(term, solver, t0, t0 + n_steps * step_size, n_steps,
                          y0, device, step_size=float(step_size), **kwargs)


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
    ``mesh``/``mesh_axis`` shard each tick's batch axis as in :func:`sdeint`
    (the tick axis stays sequential).  Other keyword arguments are as for
    :func:`sdeint`.
    """
    if tick_keys.dim() < 3:
        raise ValueError(
            f"tick_keys must stack per-tick key batches — expected a "
            f"(n_ticks, batch, ...) key array, got shape {tuple(tick_keys.shape)} "
            f"(dtype {tick_keys.dtype}); for a single flat batch call "
            "sdeint(..., batch_keys=keys)"
        )
    device = resolve_device(device)
    block = _fanout(mesh, mesh_axis, tick_keys.shape[1])
    tick_keys = tick_keys.to(device)
    if block is not None:
        out = sdeint_ticks(term, solver, t0, t1, n_steps, y0,
                           tick_keys[:, block.rows(tick_keys.shape[1])],
                           active_steps=active_steps, step_size=step_size,
                           device=device, **kwargs)
        return _gathered(out, block, 1)
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
        one = tick_solve(term, solver, t0, t1, n_steps, y0,
                         step_size=step_size, device=device, **kwargs)
        return _stack_ticks([one(tick_keys[t], active[t])
                             for t in range(n_ticks)])
    if step_size is not None:
        raise ValueError("step_size only applies with active_steps (padded "
                         "bucketed dispatch)")
    one = tick_solve(term, solver, t0, t1, n_steps, y0, device=device, **kwargs)
    return _stack_ticks([one(tick_keys[t]) for t in range(n_ticks)])
