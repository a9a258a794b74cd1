"""Training of the port (port of ``repro.train.trainer``).

Three layers, each optional, as the reference's (and the LM's accumulating
step, :func:`make_accum_train_step`, ``train_loop``'s default):

* :func:`make_sde_train_step` — ONE optimizer update from one Monte-Carlo
  batch of ``n_paths`` trajectories through
  :func:`~repro_torch.core.sdeint.sdeint`, with gradient accumulation over
  ``microbatches`` equal slices of the path axis (each slice checkpointed);
* :func:`make_scanned_step` — ``steps_per_call = K`` updates per call.
  The reference runs them in one jitted ``lax.scan``; on the card the port
  captures the K steps once into one ``torch.cuda.CUDAGraph`` and replays
  it, bitwise the K sequential steps;
* :func:`train_loop` / :func:`resilient_train_loop` — host-side driving,
  chunked when ``steps_per_call > 1``: checkpoints at chunk boundaries,
  the guard's skip-streak rollback from each chunk's ``skipped`` history,
  and batched metric read-backs.

A step never waits on the device: keys are derived on the device, the
guard's skip decision is a ``torch.where`` select and the optimizer's step
counter is a device tensor.  Loss and metrics come back as device tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import inspect
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import prng
from ..core.pytree import tree_blowup, tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..core.registry import get_solver
from ..core.sdeint import path_keys, sdeint
from ..device import resolve_device
from ..kernels._build import GraphLaunches
from ..launch.mesh import axis_block, gather_blocks
from ..models import ModelOptions, loss_fn, make_train_step
from ..models.transformer import apply_update, settle
from ..spmd import full, is_dtensor
from ..optim import adamw, cosine_schedule
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .fault_tolerance import recovery_plan

__all__ = ["TrainLoopConfig", "train_loop", "make_accum_train_step", "make_sde_train_step",
           "make_scanned_step", "init_scan_counters", "ScannedStep",
           "ResilienceConfig", "resilient_train_loop"]


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    microbatches: int = 1  # gradient-accumulation factor of the default LM step
    log_every: int = 10
    steps_per_call: int = 1  # optimizer steps fused into one dispatch


def make_accum_train_step(cfg, optimizer, opts: ModelOptions, microbatches: int = 1,
                          accum_dtype=None, grad_constraint=None):
    """The LM's train step with gradient accumulation over ``microbatches``
    (the reference's; :func:`~repro_torch.models.make_train_step` when
    ``microbatches <= 1``).

    The batch's leaves are ``(microbatches, local_batch, ...)``; the
    microbatches' gradients are summed in order into a buffer of
    ``accum_dtype`` (default float32), divided by ``microbatches`` and
    applied once; the loss is the mean of the microbatch losses.  The
    parameters are updated in place.

    ``grad_constraint``: a function of the list of accumulation buffers
    (``parameters()`` order) that lays them out, applied to the zero
    buffers and after each microbatch, as the reference applies it to its
    carry.  Each microbatch's gradient is reduced straight into the
    buffer's layout, so a data-axis layout (ZeRO-2: ``lambda bufs:
    place(bufs, opt_state_shardings(mesh, params, zero1=True).mu)``)
    turns the gradient all-reduce into a reduce-scatter onto a sharded
    buffer, and the update reads the gradient in that layout.

    The step carries ``capturable = True``, as
    :func:`~repro_torch.models.make_train_step`'s does."""
    if microbatches <= 1:
        return make_train_step(cfg, optimizer, opts)
    adt = accum_dtype or torch.float32
    constrain = grad_constraint or (lambda t: t)

    def zeros(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=adt)
        return torch.zeros(p.shape, dtype=adt, device=p.device)

    def step(params, opt_state, batch):
        leaves = list(params.parameters())
        gsum = constrain([zeros(p) for p in leaves])
        lsum = None
        for i in range(microbatches):
            mb = {k: v[i] for k, v in batch.items()}
            loss = loss_fn(cfg, params, mb, opts)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            gsum = constrain([a if g is None else a + settle(g.to(adt), a)
                              for a, g in zip(gsum, grads)])
            loss = full(loss.detach())
            lsum = loss if lsum is None else lsum + loss
        grads = [g / microbatches for g in gsum]
        opt_state, gnorm = apply_update(optimizer, params, grads, opt_state)
        return params, opt_state, {"loss": lsum / microbatches, "grad_norm": gnorm}

    step.capturable = True
    return step


def _train_block(mesh, mesh_axis, chunk_paths: int):
    """This rank's :class:`~repro_torch.launch.mesh.AxisBlock` of a
    microbatch's paths, or None without a mesh (the reference's checks)."""
    if mesh_axis is None:
        if mesh is not None:
            raise ValueError("mesh given without mesh_axis; name the axis to shard over")
        return None
    if mesh is None:
        raise ValueError(
            "mesh_axis given without mesh: pass mesh="
            "make_sample_mesh()/make_train_mesh() explicitly")
    block = axis_block(mesh, mesh_axis)
    if chunk_paths % block.world != 0:
        raise ValueError(
            f"mesh axis {mesh_axis!r} of size {block.world} does not divide "
            f"the per-microbatch path count {chunk_paths}")
    return block


def _rank_ordered_sum(partials, block):
    """Every rank's parameter partials, all-gathered (one flat buffer a
    dtype) and summed in rank order, the same on every rank."""
    out = list(partials)
    for dtype in dict.fromkeys(p.dtype for p in partials):
        idx = [i for i, p in enumerate(partials) if p.dtype == dtype]
        flat = torch.cat([partials[i].reshape(-1) for i in idx])
        ranks = gather_blocks(flat[None], block)
        total = ranks[0]
        for r in range(1, block.world):
            total = total + ranks[r]
        for i, part in zip(idx, total.split([partials[i].numel() for i in idx])):
            out[i] = part.view_as(partials[i])
    return out


def make_sde_train_step(
    solver,
    term,
    optimizer,
    y0_fn: Callable,
    loss_fn_result: Callable,
    *,
    t0: float,
    t1: float,
    n_steps: int,
    n_paths: int,
    adjoint: str = "reversible",
    save_every: Optional[int] = None,
    save_at=None,
    rtol: Optional[float] = None,
    atol: Optional[float] = None,
    remat_chunk: Optional[int] = None,
    bulk_increments: bool = True,
    noise_shape=None,
    guard: bool = True,
    microbatches: int = 1,
    mesh=None,
    mesh_axis: Optional[str] = None,
    device=None,
):
    """Neural-SDE training step ``(params, opt_state, key) -> (params,
    opt_state, metrics)``, as the reference's.

    ``params`` is the ``nn.Module`` (e.g. :class:`~repro_torch.nsde.LSDE`)
    the term takes as ``args``; ``y0_fn(params)`` is the shared initial
    state and ``loss_fn_result(params, result)`` maps the batched
    :class:`~repro_torch.core.SolveResult` (leading axis ``n_paths``) to a
    scalar.  Path ``i`` draws its noise from ``path_keys(key, n_paths)[i]``.
    ``opt_state`` is ``optimizer.init(list(params.parameters()))``.
    ``adjoint`` is ``"reversible"`` (default), ``"full"`` or
    ``"recursive"`` (with ``remat_chunk``), as for ``sdeint``.

    The step writes the updated values into the module's parameters in
    place (the module is returned, so the loop reads as the reference's);
    ``opt_state`` is replaced, not changed.  ``metrics`` holds device
    tensors: ``loss``, ``grad_norm`` and, with ``guard`` (default), the
    bool ``skipped`` — a non-finite loss or gradient skips the update
    (parameters and optimizer state pass through unchanged).

    ``microbatches > 1`` splits the path keys into that many equal slices
    (a count that does not divide ``n_paths`` raises ``ValueError``), runs
    each slice under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), sums the slices' gradients left to right and
    divides by ``microbatches``; the loss is the mean of the slice losses.

    The step carries ``capturable``: True unless the solve is adaptive (the
    controller reads its loop condition on the host every ``CHECK_EVERY``
    trials), so :func:`make_scanned_step` knows up front whether it may
    capture the step into a CUDA graph.

    ``device`` (default ``"cuda"``, which raises without a GPU) is where the
    step runs; ``key``, ``params`` and the loss's data live there.

    Every step takes the reference's mesh structure, with or without a
    mesh: (1) solve this rank's block of the paths; (2) gather the result
    leaves (integer ones ride along); (3) take the loss on the gathered
    result, with its direct parameter gradient and the result's cotangent;
    (4) pull this block's share of the cotangent back through this rank's
    solve; (5) gather the parameter partials and sum them in rank order;
    (6) add the direct gradient.  ``mesh``/``mesh_axis`` (a
    :func:`~repro_torch.launch.mesh.make_train_mesh`) shard the paths of
    each microbatch (its axis size must divide ``n_paths // microbatches``);
    every rank passes the same parameters and key and gets the same
    update.  Without a mesh the block is every path and nothing is
    gathered, so a mesh of one rank gives the single-device step bitwise.
    With ``W`` ranks the result leaves and the loss are the single-device
    ones wherever the per-path work does not depend on the block's size;
    the gradients sum ``W`` partials in rank order where one device sums
    all paths in one weight-gradient product, so they agree to a reorder
    bound, not bitwise (ROADMAP C, "Known cross-framework differences").
    """
    device = resolve_device(device)
    solver = get_solver(solver)
    microbatches = max(int(microbatches), 1)
    if n_paths % microbatches != 0:
        raise ValueError(
            f"microbatches={microbatches} does not divide n_paths={n_paths}")
    chunk_paths = n_paths // microbatches
    block = _train_block(mesh, mesh_axis, chunk_paths)

    def solve_block(params, keys):
        return sdeint(term, solver, t0, t1, n_steps, y0_fn(params), None,
                      args=params, adjoint=adjoint, save_every=save_every,
                      save_at=save_at, rtol=rtol, atol=atol, remat_chunk=remat_chunk,
                      noise_shape=noise_shape, batch_keys=keys,
                      bulk_increments=bulk_increments, device=device)

    def loss_and_grads(params, leaves, keys):
        rows = slice(None) if block is None else block.rows(keys.shape[0])
        # (1) this rank's block, its graph kept for the pullback
        if microbatches == 1:
            res = solve_block(params, keys[rows])
        else:
            res = checkpoint(solve_block, params, keys[rows], use_reentrant=False,
                             preserve_rng_state=False)
        # (2) the result leaves, gathered
        flat, treedef = tree_flatten(res)
        floats = [i for i, x in enumerate(flat) if x.is_floating_point()]
        whole = [x.detach() if block is None else gather_blocks(x, block) for x in flat]
        for i in floats:
            whole[i].requires_grad_()
        # (3) the loss on the whole result: direct gradient and cotangent
        loss = loss_fn_result(params, tree_unflatten(treedef, whole))
        grads = torch.autograd.grad(loss, leaves + [whole[i] for i in floats],
                                    allow_unused=True)
        g_direct, f_bar = grads[:len(leaves)], grads[len(leaves):]
        # (4) this block's share of the cotangent through this rank's solve
        pull = [(flat[i], fb[rows]) for i, fb in zip(floats, f_bar)
                if fb is not None and flat[i].requires_grad]
        partial = (torch.autograd.grad([o for o, _ in pull], leaves, [c for _, c in pull],
                                       allow_unused=True)
                   if pull else [None] * len(leaves))
        partial = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, partial)]
        # (5) the partials of every rank, summed in rank order
        g_paths = partial if block is None else _rank_ordered_sum(partial, block)
        # (6)
        grads = [gp if gd is None else gd + gp for gd, gp in zip(g_direct, g_paths)]
        return loss.detach(), grads

    def step(params, opt_state, key):
        leaves = list(params.parameters())
        keys = path_keys(key, n_paths)
        if microbatches == 1:
            loss, grads = loss_and_grads(params, leaves, keys)
        else:
            gsum = [torch.zeros_like(p) for p in leaves]
            losses = []
            for kc in keys.reshape(microbatches, chunk_paths, keys.shape[-1]):
                loss_c, g = loss_and_grads(params, leaves, kc)
                gsum = [a + b for a, b in zip(gsum, g)]
                losses.append(loss_c)
            loss = torch.stack(losses).mean()
            grads = [g / microbatches for g in gsum]
        old = [p.detach() for p in leaves]
        new_p, new_s, gnorm = optimizer.update(grads, opt_state, old)
        metrics = {"loss": loss, "grad_norm": gnorm}
        if guard:
            bad = tree_blowup(grads) | ~torch.isfinite(loss)
            keep = lambda new, prev: torch.where(bad, prev, new)  # noqa: E731
            new_p, new_s = tree_map(keep, (new_p, new_s), (old, opt_state))
            metrics["skipped"] = bad
        with torch.no_grad():
            for p, v in zip(leaves, new_p):
                p.copy_(v)
        return params, new_s, metrics

    step.capturable = not getattr(solver, "adaptive", False)
    return step


def init_scan_counters(device=None):
    """Device-resident counters threaded through a scanned step: ``steps``
    dispatched and guard-``skipped`` totals (int32 scalars on ``device``,
    default ``"cuda"``)."""
    device = resolve_device(device)
    return {"steps": torch.zeros((), dtype=torch.int32, device=device),
            "skipped": torch.zeros((), dtype=torch.int32, device=device)}


def _takes_step(step_fn) -> bool:
    try:
        return len(inspect.signature(step_fn).parameters) >= 4
    except (TypeError, ValueError):  # a callable with an opaque signature
        return False


def _state_leaves(tree):
    """The tensors of a state tree; a module's are its parameters."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    return tree_leaves(tree)


def _stack_history(metrics):
    """Per-step metric dicts stacked leafwise into ``(K,)`` histories."""
    return tree_map(lambda *xs: torch.stack(xs), *metrics)


class _ChunkGraph:
    """One chunk of steps captured once into a CUDA graph and replayed.

    ``run(state, inputs, steps)`` runs the chunk (or its first ``steps``
    steps) eagerly and returns ``(state, history)``; ``state`` is a tuple of
    trees (an ``nn.Module`` among them is updated in place by the steps),
    ``inputs`` a tree of tensors.  The first call warms one step up on a
    side stream (the module's parameters are put back afterwards), captures
    the whole chunk on static buffers — clones of the state's tensors and
    of the inputs — and replays; every call copies the caller's state and
    inputs into those buffers first (no copy where the caller passes the
    buffers back), replays, and returns the static state, the history
    cloned out of the graph's pool, and the launches the graph made
    counted through :class:`~repro_torch.kernels._build.GraphLaunches`.
    A capture that fails raises: nothing falls back to eager steps."""

    def __init__(self, run: Callable):
        self.run = run
        self.graph = None
        self.record = GraphLaunches()
        self.capture_seconds = None

    def _capture(self, state, inputs):
        device = tree_leaves(inputs)[0].device
        self.state = tuple(s if isinstance(s, nn.Module)
                           else tree_map(torch.clone, s) for s in state)
        self.inputs = tree_map(torch.clone, inputs)
        modules = [s for s in self.state if isinstance(s, nn.Module)]
        saved = [[t.detach().clone() for t in m.state_dict().values()]
                 for m in modules]
        start = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.run(self.state, self.inputs, 1)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for m, values in zip(modules, saved):
                for t, v in zip(m.state_dict().values(), values):
                    t.copy_(v)
        graph = torch.cuda.CUDAGraph()
        # Another graph destroyed while this one is captured (by the cyclic
        # collector) would invalidate the capture: collect before, not during.
        gc.collect()
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with self.record.capturing(), torch.cuda.graph(graph):
                out, self.history = self.run(self.state, self.inputs, None)
                with torch.no_grad():
                    for dst, src in zip(_state_leaves(self.state),
                                        _state_leaves(out)):
                        if dst is not src:
                            dst.copy_(src)
        finally:
            if gc_was_enabled:
                gc.enable()
        self.capture_seconds = time.perf_counter() - start
        self.graph = graph

    def __call__(self, state, inputs):
        if self.graph is None:
            self._capture(state, inputs)
        with torch.no_grad():
            for mine, given in zip(self.state, state):
                if isinstance(mine, nn.Module):
                    if given is not mine:
                        raise ValueError(
                            "a graphed chunk updates the module it was captured "
                            "with in place; pass that module (make a new "
                            "scanned step for another)")
                    continue
                for dst, src in zip(_state_leaves(mine), _state_leaves(given)):
                    if dst.data_ptr() != src.data_ptr():
                        dst.copy_(src)
            for dst, src in zip(tree_leaves(self.inputs), tree_leaves(inputs)):
                dst.copy_(src)
        self.graph.replay()
        self.record.replay()
        return self.state, tree_map(torch.clone, self.history)


def _scan_steps(step_fn, steps_per_call, takes_step, state, inputs, steps=None):
    """``steps_per_call`` steps (or the first ``steps``) from ``(params,
    opt_state, counters)`` with inputs ``(key, step0)``; returns the state
    and the metric histories.  A module-level function, so that a chunk
    graph holding it does not hold its :class:`ScannedStep` in a cycle (a
    graph freed by the cyclic collector during another capture would break
    that capture)."""
    params, opt_state, counters = state
    key, step0 = inputs
    hist = []
    for j in range(steps_per_call if steps is None else steps):
        s = step0 + j
        k = prng.fold_in(key, s)
        params, opt_state, m = (step_fn(params, opt_state, k, s) if takes_step
                                else step_fn(params, opt_state, k))
        sk = m.get("skipped") if isinstance(m, dict) else None
        counters = {"steps": counters["steps"] + 1,
                    "skipped": counters["skipped"]
                    + (0 if sk is None else sk.to(torch.int32))}
        hist.append(m)
    return (params, opt_state, counters), _stack_history(hist)


class ScannedStep:
    """``steps_per_call`` optimizer updates per call (see
    :func:`make_scanned_step`).

    ``graphed`` is True once the calls run as one CUDA graph; ``chunk`` is
    the :class:`_ChunkGraph` then (its ``capture_seconds`` and its
    ``record`` of captured launches)."""

    def __init__(self, step_fn: Callable, steps_per_call: int, capturable: bool,
                 donate: bool):
        self.steps_per_call = steps_per_call
        self.capturable = capturable
        self.donate = donate
        self.graphed = False
        self.chunk = None
        self._run = functools.partial(_scan_steps, step_fn, steps_per_call,
                                      _takes_step(step_fn))

    def __call__(self, params, opt_state, counters, key, step0):
        if not isinstance(step0, torch.Tensor):
            step0 = torch.full((), int(step0), dtype=torch.int64,
                               device=key.device)
        state, inputs = (params, opt_state, counters), (key, step0)
        if not (self.capturable and key.is_cuda):
            (params, opt_state, counters), hist = self._run(state, inputs)
            return params, opt_state, counters, hist
        if self.chunk is None:
            self.chunk = _ChunkGraph(self._run)
        (params, opt_state, counters), hist = self.chunk(state, inputs)
        self.graphed = True
        if not self.donate:
            opt_state, counters = tree_map(torch.clone, (opt_state, counters))
        return params, opt_state, counters, hist


def make_scanned_step(step_fn: Callable, steps_per_call: int, *,
                      jit: bool = True, donate: bool = True) -> ScannedStep:
    """Fuse ``steps_per_call = K`` optimizer updates into one call.

    ``step_fn`` is a ``(params, opt_state, key) -> (params, opt_state,
    metrics)`` step (a :func:`make_sde_train_step` product; a step taking a
    fourth ``step`` argument receives the global step as a device int
    tensor, which is how tests inject step-indexed faults on the device).
    The returned callable is

        ``scanned(params, opt_state, counters, key, step0)
            -> (params, opt_state, counters, metrics_hist)``

    running global steps ``step0 .. step0 + K - 1``; step ``s`` uses
    ``prng.fold_in(key, s)`` with ``s`` a device tensor, the sequential
    loops' convention, so the result is bitwise the K sequential steps.
    Each leaf of ``metrics`` comes back as a ``(K,)`` device history and
    ``counters`` (:func:`init_scan_counters`) accumulate the dispatched and
    skipped totals on the device.  ``step0`` may be an int or a device int
    tensor; chunks of another length need another scanned step (the loops
    keep one per length).

    With ``jit`` (default) on the card, a step marked ``capturable`` (see
    :func:`make_sde_train_step`; any callable may carry the attribute) is
    captured once, K steps into one ``torch.cuda.CUDAGraph``, and every
    call replays it: ``key`` and ``step0`` are copied into the graph's
    static buffers, the module's parameters are updated in place, and
    ``opt_state`` and ``counters`` are copied into the graph's static input
    buffers, which the call returns (the reference's donation: pass them
    back and nothing is copied; ``donate=False`` returns copies).  A step
    not marked capturable runs its K steps eagerly inside the call, as does
    every step on the CPU (the reference off the TPU); ``scanned.graphed``
    says which ran.  A capture that fails raises.
    """
    K = int(steps_per_call)
    if K < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    return ScannedStep(step_fn, K, bool(jit) and getattr(step_fn, "capturable", False),
                       donate)


def _read_back(tensors):
    """Device scalars and vectors as Python floats, in ONE transfer."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    values = flat.tolist()
    out, i = [], 0
    for t in tensors:
        out.append(values[i:i + t.numel()])
        i += t.numel()
    return out


def train_loop(
    cfg,
    params,
    data_iter,
    *,
    optimizer=None,
    opts=None,
    loop: TrainLoopConfig = TrainLoopConfig(),
    step_fn: Optional[Callable] = None,
    to_device: Optional[Callable] = None,
) -> Dict[str, Any]:
    """Drive a batch-consuming ``step_fn(params, opt_state, batch) ->
    (params, opt_state, metrics)`` for ``loop.steps`` steps.

    ``params`` is an ``nn.Module`` (its parameters updated in place, as
    :func:`make_sde_train_step` does) or a tree of tensors; ``opt_state``
    starts as ``optimizer.init`` of them (default optimizer: the
    reference's AdamW on a cosine schedule).  ``data_iter`` is an iterable
    of batches, or a step-pure source with ``batch_at(step)`` (exact replay
    after a restart); ``to_device`` (default: every leaf as a tensor on the
    parameters' device) moves a batch of numpy arrays.

    With ``loop.steps_per_call = K > 1`` the loop stacks K batches and runs
    them as one chunk — on the card one CUDA graph per chunk length when
    ``step_fn`` is marked ``capturable``, the stacked batches copied into
    its static buffer — and checkpoints land at chunk boundaries.  Metrics
    are read back ONCE at the end; ``n_dispatches`` counts the step calls
    (K = 1) or chunks, and ``graphs`` maps each chunk length that ran as a
    CUDA graph to it (its ``capture_seconds`` and ``record`` of captured
    launches; a call replays it on a state and stacked batches).  With
    ``loop.ckpt_dir`` the loop resumes from the latest checkpoint there,
    restoring into ``params`` and the optimizer state in place, and saves
    ``(params, opt_state)`` with ``extra={"steps_per_call": K}``.

    ``step_fn`` defaults to the LM's step, ``make_accum_train_step(cfg,
    optimizer, opts or ModelOptions(), loop.microbatches)`` with ``params``
    an :class:`~repro_torch.models.LMParams` (batches of ``tokens``,
    ``labels`` and ``loss_mask``, with a leading microbatch axis when
    ``loop.microbatches > 1``); it is marked capturable, so on the card
    its chunks run as CUDA graphs, bitwise the eager steps."""
    device = _state_leaves(params)[0].device
    optimizer = optimizer or adamw(cosine_schedule(3e-4, 10, loop.steps))
    if step_fn is None:
        step_fn = make_accum_train_step(cfg, optimizer, opts or ModelOptions(),
                                        loop.microbatches)
    opt_state = optimizer.init(_state_leaves(params)
                               if isinstance(params, nn.Module) else params)
    if to_device is None:
        to_device = lambda b: tree_map(  # noqa: E731
            lambda x: torch.as_tensor(x, device=device), b)
    start = 0
    if loop.ckpt_dir:
        last = latest_step(loop.ckpt_dir)
        if last is not None:
            params, opt_state = restore_checkpoint(loop.ckpt_dir, last,
                                                   (params, opt_state))
            start = last
    K = max(int(loop.steps_per_call), 1)
    step_pure = hasattr(data_iter, "batch_at")
    it = None if step_pure else iter(data_iter)
    get_batch = (lambda s: data_iter.batch_at(s)) if step_pure else (lambda s: next(it))

    t0 = time.time()
    n_dispatches = 0
    pending = []  # (step info, device losses): read back once at the end
    chunk_cache: Dict[int, Callable] = {}
    if K == 1:
        for step in range(start, loop.steps):
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 to_device(get_batch(step)))
            n_dispatches += 1
            if (step + 1) % loop.log_every == 0 or step == loop.steps - 1:
                pending.append(((step + 1,), metrics["loss"]))
            if loop.ckpt_dir and (step + 1) % loop.ckpt_every == 0:
                save_checkpoint(loop.ckpt_dir, step + 1, (params, opt_state),
                                extra={"steps_per_call": K})
    else:
        graphable = device.type == "cuda" and getattr(step_fn, "capturable", False)

        def chunk_fn(length):
            if length not in chunk_cache:
                def run(state, batches, steps=None):
                    p, o = state
                    hist = []
                    for j in range(length if steps is None else steps):
                        p, o, m = step_fn(p, o, tree_map(lambda x: x[j], batches))
                        hist.append(m)
                    return (p, o), _stack_history(hist)

                chunk_cache[length] = _ChunkGraph(run) if graphable else run
            return chunk_cache[length]

        step = start
        last_ckpt = start
        while step < loop.steps:
            length = min(K, loop.steps - step)
            batches = [get_batch(s) for s in range(step, step + length)]
            stacked = to_device(tree_map(
                lambda *xs: np.stack([np.asarray(x) for x in xs]), *batches))
            (params, opt_state), hist = chunk_fn(length)((params, opt_state),
                                                          stacked)
            n_dispatches += 1
            pending.append(((step, length), hist["loss"]))
            step += length
            if loop.ckpt_dir and step - last_ckpt >= loop.ckpt_every:
                save_checkpoint(loop.ckpt_dir, step, (params, opt_state),
                                extra={"steps_per_call": K})
                last_ckpt = step

    fetched = _read_back([d for _, d in pending])  # the ONE metrics read-back
    losses = []
    for (info, _), vals in zip(pending, fetched):
        if K == 1:
            losses.append((info[0], vals[0]))
        else:
            s0, length = info
            for j in range(length):
                s1 = s0 + j + 1
                if s1 % loop.log_every == 0 or s1 == loop.steps:
                    losses.append((s1, vals[j]))
    graphs = {n: c for n, c in chunk_cache.items() if isinstance(c, _ChunkGraph)}
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "wall_s": time.time() - t0, "n_dispatches": n_dispatches, "graphs": graphs}


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of :func:`resilient_train_loop`, as the reference's.

    ``skip_patience`` consecutive guard-skipped steps trigger a rollback to
    the latest checkpoint; checkpoints are written every ``ckpt_every``
    *productive* steps (at chunk boundaries when chunked), so a rollback
    never restores a state reached through skipped steps.  ``mesh_shape`` /
    ``hosts_per_pod`` feed :func:`recovery_plan` when the heartbeat monitor
    reports dead hosts.  ``steps_per_call = K > 1`` runs the loop in chunks
    of K steps through :func:`make_scanned_step`, with one metrics
    read-back a chunk; a fault-free run is then bitwise the stepwise one."""

    steps: int = 100
    ckpt_every: int = 10
    ckpt_dir: Optional[str] = None
    skip_patience: int = 3
    mesh_shape: tuple = (1, 1, 1)
    hosts_per_pod: int = 1
    steps_per_call: int = 1


def resilient_train_loop(
    step_fn: Callable,
    params,
    opt_state,
    key,
    *,
    res: ResilienceConfig = ResilienceConfig(),
    monitor=None,
    tracker=None,
    host: int = 0,
) -> Dict[str, Any]:
    """Drive a guarded SDE train step with skip-streak rollback and fleet
    health bookkeeping (the reference's, step for step).

    ``step_fn`` is a :func:`make_sde_train_step` product (or a four-argument
    ``(params, opt_state, key, step)`` step, ``step`` a device int tensor).
    Step ``i`` uses ``prng.fold_in(key, i)``, so a rollback replays the keys
    it first saw.

    With ``res.steps_per_call = 1`` the loop calls the step once a step and
    reads its ``skipped`` flag (one sync a step, as the reference's); the
    losses come back in ONE transfer at the end.  With ``K > 1`` it runs
    :func:`make_scanned_step` chunks (graphed on the card when the step is
    marked capturable) and reads each chunk's loss and ``skipped``
    histories in one transfer; the skip streak carries across chunks and a
    rollback at in-chunk position ``j`` restores the latest checkpoint and
    re-runs from step ``j + 1``.  Restores write into the parameters and
    the optimizer state in place.

    Per dispatch the loop records the step time into ``tracker``
    (``record``, or ``record_chunk`` when chunked) and beats ``monitor``;
    dead hosts add a :func:`recovery_plan` against ``res.mesh_shape`` to the
    history.  Returns ``params``, ``opt_state`` and the history: per-step
    ``losses`` and ``skipped``, ``rollbacks``, ``recovery_plans`` and
    ``goodput`` (productive steps / steps)."""
    K = max(int(res.steps_per_call), 1)
    history: Dict[str, Any] = {"losses": [], "skipped": [], "rollbacks": 0,
                               "recovery_plans": []}
    if res.ckpt_dir:
        save_checkpoint(res.ckpt_dir, 0, (params, opt_state),
                        extra={"steps_per_call": K})
    streak = 0
    productive = 0

    def fleet_beat(dt, n_steps_done):
        if tracker is not None:
            if n_steps_done == 1:
                tracker.record(host, dt)
            else:
                tracker.record_chunk(host, dt, n_steps_done)
        if monitor is not None:
            monitor.beat(host)
            dead = monitor.dead_hosts()
            if dead:
                history["recovery_plans"].append(recovery_plan(
                    res.mesh_shape, res.hosts_per_pod, dead,
                    (latest_step(res.ckpt_dir) or 0) if res.ckpt_dir else 0))

    def rollback():
        last = latest_step(res.ckpt_dir) if res.ckpt_dir else None
        if last is None:
            return False
        restore_checkpoint(res.ckpt_dir, last, (params, opt_state))
        history["rollbacks"] += 1
        return True

    if K == 1:
        takes_step = _takes_step(step_fn)
        dev_losses = []
        for step in range(res.steps):
            k = prng.fold_in(key, step)
            t_step = time.monotonic()
            if takes_step:
                s = torch.full((), step, dtype=torch.int64, device=key.device)
                params, opt_state, metrics = step_fn(params, opt_state, k, s)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, k)
            skipped = bool(metrics.get("skipped", False))
            fleet_beat(time.monotonic() - t_step, 1)
            dev_losses.append(metrics["loss"])
            history["skipped"].append(skipped)
            if skipped:
                streak += 1
                if streak >= res.skip_patience and rollback():
                    streak = 0
            else:
                streak = 0
                productive += 1
                if res.ckpt_dir and (step + 1) % res.ckpt_every == 0:
                    save_checkpoint(res.ckpt_dir, step + 1, (params, opt_state),
                                    extra={"steps_per_call": K})
        history["losses"] = [v[0] for v in _read_back(dev_losses)]
    else:
        scan_cache: Dict[int, ScannedStep] = {}

        def scanned_for(length):
            if length not in scan_cache:
                scan_cache[length] = make_scanned_step(step_fn, length)
            return scan_cache[length]

        counters = init_scan_counters(device=key.device)
        step = 0
        since_ckpt = 0
        while step < res.steps:
            length = min(K, res.steps - step)
            t_chunk = time.monotonic()
            params, opt_state, counters, hist = scanned_for(length)(
                params, opt_state, counters, key, step)
            sk_dev = hist.get("skipped")
            if sk_dev is None:
                sk_dev = torch.zeros(length, dtype=torch.bool, device=key.device)
            # the chunk's ONE read-back: its loss and skipped histories
            losses, sk = _read_back([hist["loss"], sk_dev])
            fleet_beat(time.monotonic() - t_chunk, length)
            commit = length
            rolled = False
            for j in range(length):
                history["losses"].append(losses[j])
                history["skipped"].append(bool(sk[j]))
                if sk[j]:
                    streak += 1
                    if streak >= res.skip_patience and rollback():
                        streak = 0
                        since_ckpt = 0
                        commit = j + 1
                        rolled = True
                        break
                else:
                    streak = 0
                    productive += 1
                    since_ckpt += 1
            step += commit
            if res.ckpt_dir and not rolled and since_ckpt >= res.ckpt_every:
                save_checkpoint(res.ckpt_dir, step, (params, opt_state),
                                extra={"steps_per_call": K})
                since_ckpt = 0
    history["goodput"] = productive / max(res.steps, 1)
    return {"params": params, "opt_state": opt_state, **history}
