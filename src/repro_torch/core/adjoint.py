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
(:func:`_maybe_prediffuse`).  ``save_at`` dense output and realized
(adaptive) grids are not ported yet.
"""
from __future__ import annotations

import math
import types
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import not_yet_ported
from .brownian import BrownianPath
from .grid import TimeGrid
from .pytree import tree_add, tree_blowup, tree_flatten, tree_leaves, tree_map, tree_unflatten
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


def _run_steps(solver, term, state, grid: TimeGrid, args, dWs, n0, n1):
    """Steps ``n0 .. n1 - 1`` from ``state``."""
    for n in range(n0, n1):
        dW = _step_increment(solver, grid, dWs, n)
        state = solver.step(term, state, grid.t_of(n), grid.h_of(n), dW, args)
    return state


def _run_chunk(solver, term, state, grid: TimeGrid, args, dWs, n0, n1):
    """Steps ``n0 .. n1 - 1`` as one checkpointed region: autograd keeps the
    input state and replays the steps when the backward reaches them.  The
    replay reads the same increments (the bulk buffer's rows, or the same
    counter-based draws), so it uses no torch RNG state."""
    return checkpoint(_run_steps, solver, term, state, grid, args, dWs, n0, n1,
                      use_reentrant=False, preserve_rng_state=False)


def _solve_loop(solver, term, y0, grid: TimeGrid, args, save_every, dWs,
                guard, batch_dims, remat_chunk=None):
    """The forward loop: ``(final solver state, ys or None, diverged or None)``.
    With ``remat_chunk`` each segment runs as checkpointed chunks of that
    many steps (the recursive adjoint)."""
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
                                     plan.guard, plan.batch_dims)
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

        # Padding steps of a padded grid were skipped forward; they are
        # skipped backward too: the sweep starts at the last live step.
        for n in range(grid.n_live - 1, -1, -1):
            t, h = grid.t_of(n), grid.h_of(n)
            dW = _step_increment(solver, grid, plan.dWs, n)
            # 1. Reconstruct the pre-step state, with no graph.
            with torch.no_grad():
                prev = solver.reverse(term, state, t, h, dW, args)
            # 2. The cotangent of the save this step produced.
            if plan.save_every is not None and (n + 1) % seg_len == 0:
                idx = (n + 1) // seg_len - 1
                inc, _ = _vjp(solver.extract, state,
                              tree_map(lambda c: c[idx], ct_ys))
                ct_state = tree_add(ct_state, inc)
            # 3. Replay the step from the rebuilt state for its local VJP.
            ct_state, inc = _vjp(
                lambda s: solver.step(term, s, t, h, dW, args), prev, ct_state,
                params)
            ct_params = accumulate(ct_params, inc)
            state = prev
        # Back out through `init` (Reversible Heun's evaluates the field).
        ct_y0, inc = _vjp(lambda y: solver.init(term, grid.t0, y, args),
                          solver.extract(state), ct_state, params)
        ct_params = accumulate(ct_params, inc)
        # The grid and the increment buffer are data: no cotangent.
        return (None, *tree_leaves(ct_y0), *ct_params)


def _solve_reversible(solver, term, y0, grid: TimeGrid, args, save_every, dWs,
                      guard, batch_dims):
    y_leaves, y_def = tree_flatten(y0)
    params = _param_leaves(args)
    # The non-tensor inputs; the forward adds its outputs' pytree layouts.
    plan = types.SimpleNamespace(
        solver=solver, term=term, grid=grid, args=args, save_every=save_every,
        dWs=dWs, guard=guard, batch_dims=batch_dims, y_def=y_def,
        n_y0=len(y_leaves), params=params)
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
    dWs = None
    if bulk_increments:
        dWs = (grid.levy_increments()
               if getattr(solver, "needs_levy_area", False)
               else grid.increments())
    term, dWs = _maybe_prediffuse(solver, term, y0, grid, args, adjoint, dWs)
    if adjoint == "reversible":
        return _solve_reversible(solver, term, y0, grid, args, save_every, dWs,
                                 guard, batch_dims)
    state, ys, div = _solve_loop(solver, term, y0, grid, args, save_every, dWs,
                                 guard, batch_dims, remat_chunk)
    return SolveResult(solver.extract(state), ys, div)
