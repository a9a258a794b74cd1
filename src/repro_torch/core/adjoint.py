"""``solve()``: the one solve loop over a :class:`~repro_torch.core.grid.TimeGrid`.

Port of ``repro.core.adjoint.solve`` for fixed grids under the full adjoint
(autograd through the loop).  The reference's ``lax.scan`` becomes a Python
loop over steps, grouped into ``save_every`` segments:

* the noise is bulk-realized by default — every step's increment comes from
  one vectorized driver pass before the loop
  (:meth:`~repro_torch.core.grid.TimeGrid.increments`), bitwise-equal to
  per-step draws (``bulk_increments=False``);
* the divergence guard reduces at segment boundaries on the device (a bool
  tensor carried through the loop, never read by the host), so guarded
  solves run exactly the unguarded steps;
* a padded grid loops its ``n_active`` live steps only.

The recursive and reversible adjoints, ``save_at`` dense output, realized
(adaptive) grids and the prediffused additive fast path are not ported yet;
an additive term takes the diagonal route, which the reference
documents as bitwise-equal to its prediffused one.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..device import not_yet_ported
from .brownian import BrownianPath
from .grid import TimeGrid
from .pytree import tree_blowup, tree_map

__all__ = ["SolveResult", "solve"]


class SolveResult(NamedTuple):
    y_final: Any
    ys: Any  # (n_saves, ...) pytree of saved states, or None
    # Per-path bool: did the state go non-finite or past the guard threshold?
    # None when the guard is off.
    diverged: Any = None


def _segment_counts(n_steps: int, save_every: Optional[int]):
    if save_every is None:
        return 1, n_steps
    if n_steps % save_every != 0:
        raise ValueError(f"n_steps={n_steps} not divisible by save_every={save_every}")
    return n_steps // save_every, save_every


def _as_grid(grid) -> TimeGrid:
    if isinstance(grid, TimeGrid):
        return grid
    if isinstance(grid, BrownianPath):
        return TimeGrid.from_path(grid)
    raise TypeError(
        f"solve() integrates over a TimeGrid (or a BrownianPath, wrapped "
        f"automatically); got {type(grid).__name__} — build one with "
        "TimeGrid.uniform(...) or realize_grid(...)"
    )


def _pick_step(dWs, n):
    """Step ``n``'s increment from the stacked bulk realization."""
    return tree_map(lambda x: x[n], dWs)


def _solve_loop(solver, term, y0, grid: TimeGrid, args, save_every, dWs,
                guard, batch_dims):
    n_seg, seg_len = _segment_counts(grid.n_steps, save_every)
    n_live = grid.n_live
    state = solver.init(term, grid.t0, y0, args)
    div = None
    saves = []
    for seg in range(n_seg):
        for n in range(seg * seg_len, min((seg + 1) * seg_len, n_live)):
            dW = grid.increment(n) if dWs is None else _pick_step(dWs, n)
            state = solver.step(term, state, grid.t_of(n), grid.h_of(n), dW,
                                args)
        if guard is not None:
            flag = tree_blowup(solver.extract(state), guard, batch_dims)
            div = flag if div is None else div | flag
        if save_every is not None:
            saves.append(solver.extract(state))
    ys = None
    if save_every is not None:
        ys = tree_map(lambda *xs: torch.stack(xs), saves[0], *saves[1:])
    return SolveResult(solver.extract(state), ys, div)


def solve(
    solver,
    term,
    y0,
    grid,
    args=None,
    *,
    adjoint: str = "full",
    save_every: Optional[int] = None,
    save_at=None,
    remat_chunk: Optional[int] = None,
    bulk_increments: bool = True,
    guard: Optional[float] = None,
    batch_dims: int = 0,
) -> SolveResult:
    """Integrate ``term`` over ``grid`` with ``solver`` — the solve loop.

    Parameters are the reference's (see ``repro.core.adjoint.solve``), plus
    ``batch_dims``: how many leading state axes index independent paths
    (the port writes out the batch the reference vmaps over).  The guard's
    ``diverged`` flag keeps those axes — one flag per path.

    Returns a :class:`SolveResult`: ``y_final``, ``ys`` (stacked on a
    leading ``n_steps / save_every`` axis, or None) and ``diverged`` (None
    without ``guard``).
    """
    grid = _as_grid(grid)
    if save_at is not None and save_every is not None:
        raise ValueError("save_every and save_at are mutually exclusive")
    if save_at is not None:
        raise not_yet_ported("save_at dense output")
    if grid.is_padded and save_every is not None:
        raise ValueError(
            "padded-uniform grids (bucketed dispatch) carry no saved "
            "trajectories — save_every/save_at requests must run on an "
            "exact (unpadded) grid"
        )
    if remat_chunk is not None and adjoint != "recursive":
        raise ValueError(
            f"remat_chunk configures the recursive adjoint's checkpoint "
            f"granularity and has no effect under adjoint={adjoint!r} — "
            "drop it or use adjoint='recursive'"
        )
    if adjoint in ("recursive", "reversible"):
        raise not_yet_ported(f"adjoint={adjoint!r}")
    if adjoint != "full":
        raise ValueError(f"unknown adjoint {adjoint!r}")
    dWs = grid.increments() if bulk_increments else None
    return _solve_loop(solver, term, y0, grid, args, save_every, dWs, guard,
                       batch_dims)
