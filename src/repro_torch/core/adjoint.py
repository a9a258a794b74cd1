"""``solve()``: the one solve loop over a :class:`~repro_torch.core.grid.TimeGrid`.

Port of ``repro.core.adjoint.solve`` for fixed grids under the three
adjoints:

* **full** — autograd through the loop: exact gradients of the discrete
  computation, O(n) activation memory;
* **recursive** — the same gradients with the loop cut into checkpointed
  chunks of ``remat_chunk`` steps inside each ``save_every`` segment
  (default: the largest divisor of the segment length not above its square
  root, as the reference's): the forward keeps each chunk's input state and
  the backward replays one chunk at a time under autograd
  (``torch.utils.checkpoint``, non-reentrant, so parameters reached through
  ``args`` get their cotangents);
* **reversible** — O(1) memory in the trajectory (Algorithm 1): a
  ``torch.autograd.Function`` whose forward runs the loop without a graph
  and keeps only the final solver state, and whose backward rebuilds each
  pre-step state with the solver's ``reverse`` step (exact for Reversible
  Heun and MCF, O(h^{m+1}) for EES(2,m)) and replays that step under
  autograd for its local cotangents.

The reference's ``lax.scan`` becomes a Python loop over steps, grouped into
``save_every`` segments:

* the noise is bulk-realized by default — every step's increment comes from
  one vectorized driver pass before the loop
  (:meth:`~repro_torch.core.grid.TimeGrid.increments`), bitwise-equal to
  per-step draws (``bulk_increments=False``);
* the divergence guard reduces at segment boundaries on the device (a bool
  tensor carried through the loop, never read by the host), so guarded
  solves run exactly the unguarded steps;
* a padded grid loops its ``n_active`` live steps only.

Solvers that advertise ``needs_levy_area`` (SRA1) get ``(dW, dH)`` pairs
from the Levy-augmented driver queries, in bulk and per step, forward and in
the reversible replay.  Under the full and recursive adjoints an
``"additive"`` term with bulk increments takes the prediffused fast path
(:func:`_maybe_prediffuse`).

Every adjoint also runs over a realized (adaptive) grid
(:func:`repro_torch.core.adaptive.realize_grid`): each path steps with its
own ``(t, h)`` (float64 rows cast to the state's dtype), a step is applied
only where that path's ``h > 0`` (padding steps are no-ops), and the loop
stops at the grid's ``n_active``, the batch's largest accepted count.
``save_at`` dense output runs as one flat loop that fills the save buffer
at the step owning each save time (:func:`~repro_torch.core.grid.fill_saves`);
the recursive adjoint checkpoints that loop in chunks, and the reversible
backward injects each save's cotangent in the step that owns it, plus the
saves no step covers straight into ``y0``.  The grid is data: ``ts`` and
``hs`` get no gradient.
"""
from __future__ import annotations

import dataclasses
import math
import types
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .brownian import TIME_DTYPE, BrownianPath
from .grid import TimeGrid, fill_saves, save_mask, save_times, save_weights
from .pytree import (tree_add, tree_blowup, tree_flatten, tree_leaves, tree_map,
                     tree_select_paths, tree_sub, tree_unflatten)
from .solvers import _PrediffusedTerm

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


def _step_increment(solver, grid: TimeGrid, dWs, n):
    """Step ``n``'s driver increment: a row of the bulk buffer, or a
    per-step draw (a ``(dW, dH)`` pair for a Levy-area solver)."""
    if dWs is not None:
        return _pick_step(dWs, n)
    if getattr(solver, "needs_levy_area", False):
        return grid.levy_increment(n)
    return grid.increment(n)


def _forward_increments(solver, grid: TimeGrid, dWs, n0, n1):
    """Steps ``n0 .. n1 - 1``'s increments, in order, for a forward sweep.
    Per-step queries of a tree stream ``W(ts[n])``: one descent a step where
    :meth:`~repro_torch.core.grid.TimeGrid.increment` takes two, the same
    bits (``weval`` is a pure function of the time)."""
    driver = grid.driver
    if dWs is not None or not hasattr(driver, "weval") or n0 >= n1:
        for n in range(n0, n1):
            yield _step_increment(solver, grid, dWs, n)
        return
    levy = getattr(solver, "needs_levy_area", False)
    w = driver.weval(grid.t_of(n0))
    for n in range(n0, n1):
        w_next = driver.weval(grid.t_of(n + 1))
        dW = tree_sub(w_next, w)
        if levy:
            dW = (dW, driver.levy_area(grid.t_of(n), grid.t_of(n + 1)))
        yield dW
        w = w_next


def _state_leaf(solver, state) -> torch.Tensor:
    """The leaf a realized grid's per-path ``(t, h)`` are shaped against."""
    return tree_leaves(solver.extract(state))[0]


def _grid_step(solver, term, state, grid: TimeGrid, args, dW, n):
    """Step ``n`` of ``grid`` from ``state``; on a realized grid each path
    takes its own ``(t, h)`` and keeps its state where ``h == 0``."""
    if grid.is_uniform:
        return solver.step(term, state, grid.t_of(n), grid.h_of(n), dW, args)
    t, h = grid.step_th(n, _state_leaf(solver, state))
    new = solver.step(term, state, t, h, dW, args)
    return tree_select_paths(grid.live(n), new, state)


def _run_steps(solver, term, state, grid: TimeGrid, args, dWs, n0, n1):
    """Steps ``n0 .. n1 - 1`` from ``state``."""
    for n, dW in enumerate(_forward_increments(solver, grid, dWs, n0, n1), n0):
        state = _grid_step(solver, term, state, grid, args, dW, n)
    return state


def _run_saving(solver, term, state, ys, grid: TimeGrid, args, dWs, save,
                n0, n1):
    """Steps ``n0 .. n1 - 1`` from ``state``, each filling the ``save_at``
    buffer ``ys`` at the save times it owns; returns ``(state, ys)``."""
    save_ts, eps_end, h_floor = save
    for n, dW in enumerate(_forward_increments(solver, grid, dWs, n0, n1), n0):
        new = _grid_step(solver, term, state, grid, args, dW, n)
        ys = fill_saves(ys, save_ts, grid.live(n), grid.t_of(n),
                        grid.t_of(n + 1), solver.extract(state),
                        solver.extract(new), grid.t1, eps_end, h_floor)
        state = new
    return state, ys


def _run_chunk(solver, term, state, grid: TimeGrid, args, dWs, n0, n1,
               save=None, ys=None):
    """Steps ``n0 .. n1 - 1`` as one checkpointed region: autograd keeps the
    input state (and save buffer) and replays the steps when the backward
    reaches them.  The replay reads the same increments (the bulk buffer's
    rows, or the same counter-based draws), so it uses no torch RNG state."""
    if save is not None:
        return checkpoint(_run_saving, solver, term, state, ys, grid, args,
                          dWs, save, n0, n1, use_reentrant=False,
                          preserve_rng_state=False)
    return checkpoint(_run_steps, solver, term, state, grid, args, dWs, n0, n1,
                      use_reentrant=False, preserve_rng_state=False)


def _save_consts(grid: TimeGrid, save_at):
    """``(save_ts, eps_end, h_floor)``: the constants the controller uses,
    so a realized grid's dense output equals the single pass's bitwise."""
    span = grid.t1 - grid.t0
    return save_times(save_at, grid.ts.device), 1e-9 * span, 1e-7 * span


def _saves_moved(ys, batch_dims):
    """A ``save_at`` buffer with its save axis moved behind the batch axes
    (for the guard's per-path reduction)."""
    return tree_map(lambda x: x.movedim(0, batch_dims), ys)


def _solve_saving(solver, term, y0, grid: TimeGrid, args, dWs, save, guard,
                  batch_dims, remat_chunk=None):
    """The ``save_at`` forward: one flat loop over the live steps carrying
    the dense-output buffer (checkpointed chunks with ``remat_chunk``)."""
    state = solver.init(term, grid.t0, y0, args)
    n_saves = save[0].shape[0]
    ys = tree_map(lambda l: l.expand((n_saves,) + tuple(l.shape)), y0)
    n_live = grid.n_live
    if remat_chunk is None:
        state, ys = _run_saving(solver, term, state, ys, grid, args, dWs, save,
                                0, n_live)
    else:
        for c0 in range(0, n_live, remat_chunk):
            state, ys = _run_chunk(solver, term, state, grid, args, dWs, c0,
                                   min(c0 + remat_chunk, n_live), save, ys)
    div = None
    if guard is not None:
        # Observer only: non-finites persist, so the final state and the
        # save buffer see every blow-up a per-step check would.
        div = (tree_blowup(solver.extract(state), guard, batch_dims)
               | tree_blowup(_saves_moved(ys, batch_dims), guard, batch_dims))
    return state, ys, div


def _solve_loop(solver, term, y0, grid: TimeGrid, args, save_every, dWs,
                guard, batch_dims, remat_chunk=None, save=None):
    """The forward loop: ``(final solver state, ys or None, diverged or None)``.
    With ``remat_chunk`` each segment runs as checkpointed chunks of that
    many steps (the recursive adjoint); ``save`` (``_save_consts``) runs the
    ``save_at`` loop instead."""
    if save is not None:
        return _solve_saving(solver, term, y0, grid, args, dWs, save, guard,
                             batch_dims, remat_chunk)
    n_seg, seg_len = _segment_counts(grid.n_steps, save_every)
    n_live = grid.n_live
    state = solver.init(term, grid.t0, y0, args)
    div = None
    saves = []
    for seg in range(n_seg):
        # A padded grid runs its live steps only, in chunks clipped to them.
        lo, hi = seg * seg_len, min((seg + 1) * seg_len, n_live)
        if remat_chunk is None:
            state = _run_steps(solver, term, state, grid, args, dWs, lo, hi)
        else:
            for c0 in range(lo, hi, remat_chunk):
                state = _run_chunk(solver, term, state, grid, args, dWs, c0,
                                   min(c0 + remat_chunk, hi))
        if guard is not None:
            flag = tree_blowup(solver.extract(state), guard, batch_dims)
            div = flag if div is None else div | flag
        if save_every is not None:
            saves.append(solver.extract(state))
    ys = None
    if save_every is not None:
        ys = tree_map(lambda *xs: torch.stack(xs), saves[0], *saves[1:])
    return state, ys, div


def _default_remat_chunk(seg_len: int) -> int:
    """The reference's checkpoint granularity: ``isqrt(seg_len)``, lowered
    until it divides the segment."""
    chunk = max(1, math.isqrt(seg_len))
    while seg_len % chunk != 0:
        chunk -= 1
    return chunk


# ---------------------------------------------------------------------------
# Reversible adjoint (Algorithm 1).
# ---------------------------------------------------------------------------

def _param_leaves(args):
    """The tensors of ``args`` that take gradients: an ``nn.Module``'s
    parameters, or the grad-requiring tensor leaves of a pytree."""
    if isinstance(args, torch.nn.Module):
        return [p for p in args.parameters() if p.requires_grad]
    return [x for x in tree_leaves(args)
            if isinstance(x, torch.Tensor) and x.requires_grad]


def _vjp(fn, primals, ct, params=()):
    """Cotangents of ``fn(primals)`` (a pytree) pulled back to ``primals``'
    leaves and to ``params``, given the output cotangent pytree ``ct``:
    ``(ct_primals pytree, [ct_param or None])``.  Runs ``fn`` on detached
    copies of the leaves under autograd; leaves and params ``fn`` does not
    reach get zeros and None."""
    leaves, treedef = tree_flatten(primals)
    with torch.enable_grad():
        ins = [x.detach().requires_grad_() for x in leaves]
        out = tree_leaves(fn(tree_unflatten(treedef, ins)))
        pairs = [(o, c) for o, c in zip(out, tree_leaves(ct))
                 if o.requires_grad]
        if not pairs:
            return tree_unflatten(treedef, [torch.zeros_like(x) for x in ins]), \
                [None] * len(params)
        grads = torch.autograd.grad([o for o, _ in pairs], ins + list(params),
                                    [c for _, c in pairs], allow_unused=True)
    ct_in = [torch.zeros_like(x) if g is None else g
             for x, g in zip(ins, grads[:len(ins)])]
    return tree_unflatten(treedef, ct_in), list(grads[len(ins):])


class _Reversible(torch.autograd.Function):
    """The reversible solve as one autograd node.

    Inputs: a plan (everything but tensors), then the leaves of
    ``y0`` and the parameter tensors of ``args``.  Outputs: the leaves of
    ``y_final``, of ``ys`` (with ``save_every``) and the guard's flag.  The
    forward keeps the final solver state (``save_for_backward``) and the
    bulk increment buffer, nothing of the trajectory.
    """

    @staticmethod
    def forward(ctx, plan, *inputs):
        y0 = tree_unflatten(plan.y_def, inputs[:plan.n_y0])
        state, ys, div = _solve_loop(plan.solver, plan.term, y0, plan.grid,
                                     plan.args, plan.save_every, plan.dWs,
                                     plan.guard, plan.batch_dims,
                                     save=plan.save)
        state_leaves, plan.state_def = tree_flatten(state)
        ctx.save_for_backward(*state_leaves)
        ctx.plan = plan
        y_leaves, plan.yf_def = tree_flatten(plan.solver.extract(state))
        ys_leaves, plan.ys_def = tree_flatten(ys)
        plan.n_yf, plan.n_ys = len(y_leaves), len(ys_leaves)
        outs = y_leaves + ys_leaves
        if div is not None:
            ctx.mark_non_differentiable(div)
            outs.append(div)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        plan = ctx.plan
        solver, term, grid, args, params = (plan.solver, plan.term, plan.grid,
                                            plan.args, plan.params)
        state = tree_unflatten(plan.state_def, ctx.saved_tensors)
        ct_yf = tree_unflatten(plan.yf_def, cts[:plan.n_yf])
        ct_ys = tree_unflatten(plan.ys_def, cts[plan.n_yf:plan.n_yf + plan.n_ys])
        # Inject the terminal cotangent through `extract`.
        ct_state, _ = _vjp(solver.extract, state, ct_yf)
        ct_params = [None] * len(params)
        _, seg_len = _segment_counts(grid.n_steps, plan.save_every)

        def accumulate(acc, inc):
            return [a if i is None else (i if a is None else a + i)
                    for a, i in zip(acc, inc)]

        save = plan.save
        # Steps past the grid's live prefix were skipped forward (a padded
        # grid's padding, a realized grid's steps no path takes); they are
        # skipped backward too: the sweep starts at the last live step.
        for n in range(grid.n_live - 1, -1, -1):
            live = grid.live(n)
            if grid.is_uniform:
                t, h = grid.t_of(n), grid.h_of(n)
            else:
                t, h = grid.step_th(n, _state_leaf(solver, state))
            dW = _step_increment(solver, grid, plan.dWs, n)
            # 1. Reconstruct the pre-step state, with no graph; a realized
            #    grid's padding steps were no-ops forward, and are backward.
            with torch.no_grad():
                prev = solver.reverse(term, state, t, h, dW, args)
                if not grid.is_uniform:
                    prev = tree_select_paths(live, prev, state)
            # 2. The cotangents of the saves this step produced.
            pick_old = None
            if plan.save_every is not None and (n + 1) % seg_len == 0:
                idx = (n + 1) // seg_len - 1
                inc, _ = _vjp(solver.extract, state,
                              tree_map(lambda c: c[idx], ct_ys))
                ct_state = tree_add(ct_state, inc)
            if save is not None:
                # The forward wrote ys[j] = y_old + frac_j (y_new - y_old) at
                # the saves this step owns (save_mask is disjoint across
                # steps): the y_new part goes through the post-step state
                # now, the y_old part onto the rebuilt state below.
                save_ts, eps_end, h_floor = save
                t_old, t_new = grid.t_of(n), grid.t_of(n + 1)
                m = save_mask(save_ts, live, t_old, t_new, grid.t1, eps_end)
                frac = save_weights(save_ts, t_old, t_new, h_floor)
                inc, _ = _vjp(solver.extract, state,
                              _pick_saves(m * frac, ct_ys))
                ct_state = tree_add(ct_state, inc)
                pick_old = _pick_saves(m * (1.0 - frac), ct_ys)
            # 3. Replay the step from the rebuilt state for its local VJP;
            #    on a realized grid a path the step leaves alone passes its
            #    cotangent through and adds none to the parameters.
            if grid.is_uniform:
                ct_state, inc = _vjp(
                    lambda s: solver.step(term, s, t, h, dW, args), prev,
                    ct_state, params)
            else:
                ct_in = tree_select_paths(live, ct_state,
                                          tree_map(torch.zeros_like, ct_state))
                ct_prev, inc = _vjp(
                    lambda s: solver.step(term, s, t, h, dW, args), prev,
                    ct_in, params)
                ct_state = tree_select_paths(live, ct_prev, ct_state)
            ct_params = accumulate(ct_params, inc)
            if pick_old is not None:
                inc, _ = _vjp(solver.extract, prev, pick_old)
                ct_state = tree_add(ct_state, inc)
            state = prev
        # Back out through `init` (Reversible Heun's evaluates the field).
        ct_y0, inc = _vjp(lambda y: solver.init(term, grid.t0, y, args),
                          solver.extract(state), ct_state, params)
        ct_params = accumulate(ct_params, inc)
        if save is not None:
            # Saves no step covered (at or before t0, or past where a
            # budget-exhausted realization stopped) hold y0: their
            # cotangents go straight to it.  The exact complement of the
            # steps' save_mask: the eps slack exists only where a path's
            # grid reached t1.
            save_ts, eps_end, _ = save
            t_final = grid.t_of(grid.n_steps).to(TIME_DTYPE)
            slack = torch.where(t_final >= grid.t1 - eps_end, eps_end, 0.0)
            ts = save_ts.reshape(save_ts.shape + (1,) * t_final.dim())
            w0 = (ts <= grid.t0) | (ts > t_final + slack)
            ct_y0 = tree_add(ct_y0, _pick_saves(w0, ct_ys))
        # The grid and the increment buffer are data: no cotangent.
        return (None, *tree_leaves(ct_y0), *ct_params)


def _pick_saves(weights, ct_ys):
    """``sum_j weights[j] * ct_ys[j]`` per leaf: ``weights`` is ``(n_saves,
    *batch)`` (or ``(n_saves,)``), each leaf of ``ct_ys`` ``(n_saves, *batch,
    ...)``."""
    def leaf(c):
        w = weights.reshape(tuple(weights.shape)
                            + (1,) * (c.dim() - weights.dim()))
        return (w.to(c.dtype) * c).sum(dim=0)

    return tree_map(leaf, ct_ys)


def _solve_reversible(solver, term, y0, grid: TimeGrid, args, save_every, dWs,
                      guard, batch_dims, save=None):
    y_leaves, y_def = tree_flatten(y0)
    params = _param_leaves(args)
    # The non-tensor inputs; the forward adds its outputs' pytree layouts.
    plan = types.SimpleNamespace(
        solver=solver, term=term, grid=grid, args=args, save_every=save_every,
        dWs=dWs, guard=guard, batch_dims=batch_dims, y_def=y_def,
        n_y0=len(y_leaves), params=params, save=save)
    outs = _Reversible.apply(plan, *y_leaves, *params)
    y_final = tree_unflatten(plan.yf_def, outs[:plan.n_yf])
    ys = tree_unflatten(plan.ys_def, outs[plan.n_yf:plan.n_yf + plan.n_ys])
    div = outs[-1] if guard is not None else None
    return SolveResult(y_final, ys, div)


def _maybe_prediffuse(solver, term, y0, grid: TimeGrid, args, adjoint, dWs):
    """The additive fast path: hoist the diffusion out of the step loop.

    Under ``noise="additive"`` the diffusion does not depend on ``t`` or
    ``y`` (it may depend on ``args``), so ``w = g*dW`` is formed for every
    step in one broadcast pass over the bulk buffer, under autograd, and a
    :class:`~repro_torch.core.solvers._PrediffusedTerm` combines
    ``f*h + w`` per step — the same multiply, hoisted, so results equal the
    diagonal route bitwise.  The buffer ``w`` is as large as ``dWs``, and
    both stay live for the solve.

    The full and recursive adjoints take it.  Other cases keep their term
    and buffer: the reversible adjoint (its backward treats the buffer as
    data, which would cut the diffusion parameters' cotangents), per-step
    increments (nothing to hoist over), and solvers that read
    ``term.diffusion`` or take Levy-area pairs
    (Milstein, SRA1).
    """
    if (
        dWs is None
        or getattr(term, "noise", None) != "additive"
        or adjoint not in ("full", "recursive")
        or getattr(solver, "needs_levy_area", False)
        or getattr(solver, "needs_diffusion", False)
    ):
        return term, dWs
    g0 = term.diffusion(grid.t0, y0, args)
    ws = tree_map(lambda gi, wi: gi * wi, g0, dWs)
    return _PrediffusedTerm(base=term), ws


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

    ``adjoint`` is ``"full"``, ``"recursive"`` (checkpointed chunks of
    ``remat_chunk`` steps; each ``save_every`` segment must divide into
    them) or ``"reversible"``.

    Returns a :class:`SolveResult`: ``y_final``, ``ys`` (stacked on a
    leading ``n_steps / save_every`` axis, or None) and ``diverged`` (None
    without ``guard``).
    """
    grid = _as_grid(grid)
    if save_at is not None and save_every is not None:
        raise ValueError("save_every and save_at are mutually exclusive")
    if grid.is_padded and (save_every is not None or save_at is not None):
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
    if adjoint not in ("full", "recursive", "reversible"):
        raise ValueError(f"unknown adjoint {adjoint!r}")
    if adjoint == "recursive":
        _, seg_len = _segment_counts(grid.n_steps, save_every)
        if remat_chunk is None:
            remat_chunk = _default_remat_chunk(seg_len)
        elif int(remat_chunk) < 1:
            raise ValueError(f"remat_chunk must be a positive step count, got "
                             f"{remat_chunk!r}")
        elif seg_len % int(remat_chunk) != 0:
            raise ValueError("segment length must be divisible by remat_chunk")
        remat_chunk = int(remat_chunk)
    if save_every is not None and not grid.is_uniform:
        # save_every counts a realized grid's trial slots, padding included:
        # run them all (padding steps are no-ops).
        grid = dataclasses.replace(grid, n_active=None)
    save = None if save_at is None else _save_consts(grid, save_at)
    dWs = None
    if bulk_increments:
        dWs = (grid.levy_increments()
               if getattr(solver, "needs_levy_area", False)
               else grid.increments())
    term, dWs = _maybe_prediffuse(solver, term, y0, grid, args, adjoint, dWs)
    if adjoint == "reversible":
        return _solve_reversible(solver, term, y0, grid, args, save_every, dWs,
                                 guard, batch_dims, save)
    state, ys, div = _solve_loop(solver, term, y0, grid, args, save_every, dWs,
                                 guard, batch_dims, remat_chunk, save)
    return SolveResult(solver.extract(state), ys, div)
