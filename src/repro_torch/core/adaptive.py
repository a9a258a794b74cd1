"""Adaptive grid realization: PI-controlled accept/reject over any driver.

Port of ``repro.core.adaptive``.  The embedded estimator is Appendix D of the
paper: each solver's ``step_with_error`` returns the step and the difference
from a first-order companion built from stages it already computed.

Realize-then-solve, as in the reference:

* :func:`realize_grid` runs the PI step-size controller (Gustafsson) once,
  forward only and without gradients, over a
  :class:`~repro_torch.core.brownian.VirtualBrownianTree`, and emits the
  accepted steps as a realized :class:`~repro_torch.core.grid.TimeGrid`;
  rejected trials re-query the tree over a smaller interval of the same
  path.
* :func:`repro_torch.core.adjoint.solve` then integrates over the realized
  grid with any solver under any adjoint.

:func:`integrate_adaptive` composes the two (``bounded=True``) or runs the
controller once as the solve (``bounded=False``, forward-only: what serving
runs); both walk the same trials, so their results agree bitwise.

The reference vmaps a single-path ``while_loop``.  The port writes the batch
out: every path carries its own ``t``, ``h``, ``W(t)``, previous error,
accepted and rejected counts, and its own condition ``(t1 - t > eps_end) &
(n_accepted + n_rejected < max_steps)``; each trial runs on every path and
is applied, with ``torch.where``, only where that condition holds — what
the vmapped loop does — so a path's result does not depend on its batch.
The error norm is the mean over each path's own elements.  Times and the
controller's arithmetic are float64 whatever the state's dtype; the step
receives ``t`` and ``h`` cast to the state's dtype, one value per path.

Only the host can end the loop: it reads "is any path still stepping?"
every :data:`CHECK_EVERY` trials (trials on finished paths are masked
no-ops, so the cadence changes no bit) and never past ``max_steps`` trials.
:data:`COUNTS` tallies trials and those host reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from .brownian import TIME_DTYPE
from .grid import TimeGrid, _per_path, fill_saves, save_times
from .pytree import (resolve_solver, tree_blowup, tree_leaves, tree_map, tree_select_paths,
                     tree_sub)
from .williamson import LowStorage

__all__ = ["step_with_error", "realize_grid", "RealizedGrid",
           "integrate_adaptive", "AdaptiveResult", "CHECK_EVERY", "COUNTS"]

_ERR_FLOOR = 1e-10

#: Trials between two host reads of the loop's condition.
CHECK_EVERY = 8


@dataclasses.dataclass
class ControllerCounts:
    """What the controller loops of this process cost the host: ``trials``
    (each over the whole batch) and ``syncs`` (host reads of the loop
    condition, and of the realized grid's largest accepted count).  Reset
    the fields to count one run."""

    trials: int = 0
    syncs: int = 0


COUNTS = ControllerCounts()


def step_with_error(ls: LowStorage, term, y, t, h, dW, args):
    """One 2N step from raw coefficients, returning ``(y_next, error)``."""
    from .solvers import LowStorageSolver

    return LowStorageSolver(ls).step_with_error(term, y, t, h, dW, args)


class AdaptiveResult(NamedTuple):
    """Adaptive solve output: ``y_final``/``ys`` as in
    :class:`~repro_torch.core.adjoint.SolveResult`, then per-path controller
    statistics (float64 times, int32 counts)."""

    y_final: Any
    ys: Any                  # (*batch, len(save_at), ...) from sdeint, or None
    t_final: torch.Tensor    # where integration stopped (== t1 normally)
    h_final: torch.Tensor    # last proposed step size
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    # Per-path bool blow-up flag; None with the guard off.
    diverged: Any = None


class RealizedGrid(NamedTuple):
    """Phase-1 output: the accepted-step grid plus controller statistics.

    ``grid.ts[..., :n_accepted + 1]`` are a path's accepted times, then
    ``t_final`` padding; ``grid.hs`` the step sizes (0 on padding).
    ``y_final`` is the realization's own terminal state, without gradients.
    """

    grid: TimeGrid
    y_final: Any
    t_final: torch.Tensor
    h_final: torch.Tensor
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor


def _batch_shape(driver):
    key = getattr(driver, "key", None)
    return tuple(key.shape[:-1]) if isinstance(key, torch.Tensor) else ()


def _err_norm(err, y_old, y_new, rtol, atol, batch):
    """Per-path RMS of ``err / (atol + rtol * max(|y_old|, |y_new|))`` over
    every element of every leaf, floored at ``_ERR_FLOOR``."""
    parts = []
    for e, a, b in zip(tree_leaves(err), tree_leaves(y_old), tree_leaves(y_new)):
        sc = atol + rtol * torch.maximum(a.abs(), b.abs())
        parts.append(((e / sc) ** 2).reshape(batch + (-1,)))
    ms = torch.cat(parts, dim=-1).mean(dim=-1)
    return torch.sqrt(torch.clamp_min(ms, _ERR_FLOOR * _ERR_FLOOR))


def _controller_loop(solver, term, y0, driver, args, *, t0, t1, rtol, atol,
                     h0, safety, icoeff, pcoeff, max_steps, save_at,
                     record_grid):
    """The accept/reject loop over the batch: returns ``(y, t, h, n_accepted,
    n_rejected, ys, ts_buf, hs_buf)``.

    ``record_grid`` writes each path's accepted ``(t, h)`` into
    ``max_steps``-long buffers; ``save_at`` fills the dense-output buffer
    at accept time.  Both modes walk the same trials.
    """
    span = t1 - t0
    has_noise = getattr(term, "noise", "diagonal") != "none"
    needs_levy = getattr(solver, "needs_levy_area", False)
    eps_end = 1e-9 * span
    h_floor = 1e-7 * span
    k_exp = 2.0  # embedded pair is (order, 1): exponent 1/(q+1) with q = 1
    batch = _batch_shape(driver)
    like = tree_leaves(y0)[0]
    device = like.device

    def full(value, dtype=TIME_DTYPE):
        return torch.full(batch, value, dtype=dtype, device=device)

    y = y0
    t = full(t0)
    h = full(h0)
    en_prev = full(1.0)
    na = full(0, torch.int32)
    nr = full(0, torch.int32)
    w = driver.weval(t) if has_noise else None
    ys = None
    if save_at is not None:
        save_ts = save_times(save_at, device)
        ys = tree_map(lambda l: l.expand((save_ts.shape[0],) + tuple(l.shape)),
                      y0)
    ts_buf = full(t0).unsqueeze(-1).repeat((1,) * len(batch) + (max_steps + 1,)) \
        if record_grid else None
    hs_buf = torch.zeros(batch + (max_steps,), dtype=TIME_DTYPE, device=device) \
        if record_grid else None

    for trial in range(max_steps):
        if trial % CHECK_EVERY == 0:
            COUNTS.syncs += 1
            if not bool(((t1 - t > eps_end) & (na + nr < max_steps)).any()):
                break
        COUNTS.trials += 1
        active = (t1 - t > eps_end) & (na + nr < max_steps)
        h_eff = torch.minimum(h, t1 - t)
        t_new = t + h_eff
        if has_noise:
            w_prop = driver.weval(t_new)
            dW = tree_sub(w_prop, w)
            if needs_levy:
                # Levy-area solvers take the (dW, dH) pair; the salted Levy
                # family keeps each query a pure function of its endpoints.
                dW = (dW, driver.levy_area(t, t_new))
        else:
            w_prop, dW = w, None
        y_new, err = solver.step_with_error(term, y, _per_path(t, like),
                                            _per_path(h_eff, like), dW, args)
        # The step-size sequence is data: no gradient through the controller.
        with torch.no_grad():
            en = _err_norm(err, y, y_new, rtol, atol, batch).to(TIME_DTYPE)
        ok = en <= 1.0
        accept = ok & active
        grow = safety * en ** (-(icoeff + pcoeff) / k_exp) \
            * torch.clamp_min(en_prev, _ERR_FLOOR) ** (pcoeff / k_exp)
        shrink = safety * en ** (-1.0 / k_exp)
        factor = torch.where(ok, torch.clamp(grow, 0.2, 2.0),
                             torch.clamp(shrink, 0.1, 1.0))
        h_next = torch.clamp_min(h_eff * factor, h_floor)
        if save_at is not None:
            ys = fill_saves(ys, save_ts, accept, t, t_new, y, y_new, t1,
                            eps_end, h_floor)
        if record_grid:
            nxt = (na.to(torch.int64) + 1).clamp(max=max_steps).unsqueeze(-1)
            ts_buf.scatter_(-1, nxt, torch.where(
                accept, t_new, ts_buf.gather(-1, nxt).squeeze(-1)).unsqueeze(-1))
            cur = na.to(torch.int64).clamp(max=max_steps - 1).unsqueeze(-1)
            hs_buf.scatter_(-1, cur, torch.where(
                accept, h_eff, hs_buf.gather(-1, cur).squeeze(-1)).unsqueeze(-1))
        y = tree_select_paths(accept, y_new, y)
        if has_noise:
            w = tree_select_paths(accept, w_prop, w)
        t = torch.where(accept, t_new, t)
        h = torch.where(active, h_next, h)
        en_prev = torch.where(accept, en, en_prev)
        na = na + accept.to(torch.int32)
        nr = nr + (active & ~ok).to(torch.int32)
    return y, t, h, na, nr, ys, ts_buf, hs_buf


def _window(driver, t0, t1):
    if t0 is None:
        t0 = driver.t0 if driver is not None else 0.0
    if t1 is None:
        t1 = driver.t1 if driver is not None else 1.0
    t0, t1 = float(t0), float(t1)
    if not t1 > t0:
        raise ValueError(f"need t1 > t0, got t0={t0}, t1={t1}")
    return t0, t1


def _check_driver(term, driver):
    if getattr(term, "noise", "diagonal") != "none" and driver is None:
        raise ValueError(
            "term has noise but no driver was given; pass a "
            "VirtualBrownianTree (or set term.noise='none' for ODE mode)"
        )


def realize_grid(
    solver,
    term,
    y0,
    driver=None,
    args: Any = None,
    *,
    t0: Optional[float] = None,
    t1: Optional[float] = None,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    h0: Optional[float] = None,
    safety: float = 0.9,
    icoeff: float = 0.7,
    pcoeff: float = 0.4,
    max_steps: int = 1024,
) -> RealizedGrid:
    """Phase 1: run the accept/reject controller once and emit the grid.

    Arguments are the reference's.  ``y0`` carries the driver key's batch
    axes (one path per key).  The controller runs without gradients: the
    realized step sequence is data, and phase 2
    (:func:`~repro_torch.core.adjoint.solve` over ``result.grid``) carries
    the gradients.  A step is accepted when the RMS of ``err / (atol + rtol
    * max(|y|, |y_new|))`` is <= 1; the next step scales by the Gustafsson
    PI factor (clipped to [0.2, 2]) after an accept and by the pure-I
    shrink (clipped to [0.1, 1]) after a reject.  ``max_steps`` bounds the
    trials of each path and is the realized grid's length; if a path
    exhausts it, its grid stops short of ``t1`` (see ``t_final``).
    """
    solver = resolve_solver(solver, require_error_estimate=True)
    t0, t1 = _window(driver, t0, t1)
    _check_driver(term, driver)
    if h0 is None:
        h0 = (t1 - t0) / 16.0
    with torch.no_grad():
        y, t, h, na, nr, _, ts_buf, hs_buf = _controller_loop(
            solver, term, y0, driver, args, t0=t0,
            t1=t1, rtol=rtol, atol=atol, h0=h0, safety=safety, icoeff=icoeff,
            pcoeff=pcoeff, max_steps=int(max_steps), save_at=None,
            record_grid=True)
        # Entries past each path's last accept still hold t0: pad them with
        # the path's final time, so its padding steps have zero length.
        idx = torch.arange(ts_buf.shape[-1], device=ts_buf.device)
        ts = torch.where(idx <= na.to(torch.int64).unsqueeze(-1), ts_buf,
                         t.unsqueeze(-1))
    COUNTS.syncs += 1
    n_live = int(na.max()) if na.numel() else 0
    grid = TimeGrid(ts, driver, t0, t1, hs=hs_buf, n_active=n_live)
    return RealizedGrid(grid=grid, y_final=y, t_final=t, h_final=h,
                        n_accepted=na, n_rejected=nr)


def integrate_adaptive(
    solver,
    term,
    y0,
    driver=None,
    args: Any = None,
    *,
    t0: Optional[float] = None,
    t1: Optional[float] = None,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    h0: Optional[float] = None,
    safety: float = 0.9,
    icoeff: float = 0.7,
    pcoeff: float = 0.4,
    max_steps: int = 1024,
    save_at=None,
    bounded: bool = True,
    adjoint: str = "full",
    remat_chunk: Optional[int] = None,
    bulk_increments: bool = True,
    guard: Optional[float] = None,
) -> AdaptiveResult:
    """PI-controlled adaptive integration of ``term`` over ``[t0, t1]``.

    Arguments are the reference's (``repro.core.adaptive.integrate_adaptive``);
    ``y0`` carries the driver key's batch axes.  ``bounded=True``:
    :func:`realize_grid`, then :func:`~repro_torch.core.adjoint.solve` over
    the realized grid under ``adjoint`` (``"full"``, ``"recursive"`` or
    ``"reversible"``), differentiable.  ``bounded=False``: one forward-only
    controller pass (full adjoint only), bitwise equal.  ``save_at``: output
    times, interpolated linearly between accepted steps (``ys`` gains a
    leading ``len(save_at)`` axis; saves at or before ``t0`` hold ``y0``).
    ``guard``: per-path blow-up flags (``diverged``).
    """
    solver = resolve_solver(solver, require_error_estimate=True)
    if adjoint not in ("full", "recursive", "reversible"):
        raise ValueError(f"unknown adjoint {adjoint!r}")
    if not bounded and adjoint != "full":
        raise ValueError(
            f"bounded=False is the single forward-only controller pass and "
            f"cannot host the {adjoint!r} adjoint; use bounded=True "
            "(realize-then-solve) for gradients"
        )
    t0, t1 = _window(driver, t0, t1)
    _check_driver(term, driver)
    if h0 is None:
        h0 = (t1 - t0) / 16.0

    if not bounded:
        y, t, h, na, nr, ys, _, _ = _controller_loop(
            solver, term, y0, driver, args, t0=t0, t1=t1, rtol=rtol,
            atol=atol, h0=h0, safety=safety, icoeff=icoeff, pcoeff=pcoeff,
            max_steps=int(max_steps), save_at=save_at, record_grid=False)
        div = None
        if guard is not None:
            div = tree_blowup(y, guard, len(_batch_shape(driver)))
        return AdaptiveResult(y_final=y, ys=ys, t_final=t, h_final=h,
                              n_accepted=na, n_rejected=nr, diverged=div)

    from .adjoint import solve

    rg = realize_grid(
        solver, term, y0, driver, args, t0=t0, t1=t1, rtol=rtol, atol=atol,
        h0=h0, safety=safety, icoeff=icoeff, pcoeff=pcoeff,
        max_steps=int(max_steps))
    out = solve(solver, term, y0, rg.grid, args, adjoint=adjoint,
                save_at=save_at, remat_chunk=remat_chunk,
                bulk_increments=bulk_increments, guard=guard,
                batch_dims=len(_batch_shape(driver)))
    return AdaptiveResult(y_final=out.y_final, ys=out.ys, t_final=rg.t_final,
                          h_final=rg.h_final, n_accepted=rg.n_accepted,
                          n_rejected=rg.n_rejected, diverged=out.diverged)
