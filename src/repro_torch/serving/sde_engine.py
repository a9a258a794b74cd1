"""Batched Monte-Carlo sampling engine: a façade over scheduler + executor.

Port of the synchronous ``repro.serving.sde_engine.SDESampleEngine``.
Requests (solver spec, horizon, number of paths) join a priority-FIFO queue;
the engine serves them in fixed-size ticks of ``slots`` trajectories, filling
each tick with paths of compatible queued requests (continuous batching),
``ticks_per_dispatch`` ticks per host round trip:

* :class:`~repro_torch.serving.scheduler.Scheduler` — the host side: queue,
  admission control (:class:`QueueFull`), priorities, cancellation, slot
  plans with reservations, result scatter and retirement;
* :class:`~repro_torch.serving.executor.TickExecutor` — the device side:
  runs a tick stack of path keys through ``sdeint_ticks``, on the card as
  replays of captured tick graphs (adaptive keys and gloo meshes eager).

Path ``i`` of request ``r`` always uses ``fold_in(PRNGKey(seed_r), i)`` —
the reference's convention, computed on the device — so a request's samples
are independent of slot assignment, tick boundaries, dispatch depth,
bucketing and double buffering, and name the same Brownian paths as the
reference engine's.  Double buffering and bucketing are on by default, as
are the divergence guard and the retry ladder (halve ``h``, then fall back
to ``ees27``).

``"auto"`` and ``"auto:stiffness=...,noise=..."`` specs resolve at submit
time through :func:`~repro_torch.core.registry.select_solver` with the
term's declared noise and the request's step ``dt``; the resolved spec is
the request's signature, so requests that resolve alike share an executor.

:meth:`SDESampleEngine.warmup` prepares the callables (and builds the
kernel libraries) expected traffic needs; ``compile_cache_dir`` keeps those
libraries where a later process loads them (see
:func:`~repro_torch.serving.executor.enable_persistent_compile_cache`).
:class:`~repro_torch.serving.async_engine.AsyncSDESampleEngine` serves a
continuous request stream over this engine.

Adaptive requests (an ``"ees25:adaptive"``-style spec with ``rtol`` /
``atol`` / ``save_at``) run one forward-only controller pass per tick over
a Virtual Brownian Tree per path; their results carry per-path
``t_final``, ``n_accepted`` and ``n_rejected``.

With ``mesh``/``mesh_axis`` in the config each tick's slot axis is sharded
over a mesh axis (``slots`` a multiple of its size): every rank runs the
same engine on the same requests — the scheduler's plan is deterministic,
so each plans the same ticks — solves its block of every tick's slots, and
gathers the rest, so every rank holds every request's results.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.prng import PRNGKey
from ..core.registry import parse_solver_spec, select_solver
from ..core.sdeint import path_keys
from ..device import resolve_device
from .bucketing import BucketKey, BucketingConfig, bucket_key, group_key
from .executor import TickExecutor, enable_persistent_compile_cache
from .scheduler import (
    STAT_FIELDS,
    QueueFull,
    RetryPolicy,
    SampleRequest,
    SampleResult,
    Scheduler,
    SlotPlan,
    make_request,
)

__all__ = ["SDESampleConfig", "SampleRequest", "SampleResult",
           "SDESampleEngine", "QueueFull", "RetryPolicy"]


@dataclasses.dataclass(frozen=True)
class SDESampleConfig:
    slots: int = 64              # trajectories integrated per tick
    dtype: Any = torch.float32
    ticks_per_dispatch: int = 1  # ticks per host round trip
    mesh: Any = None             # device mesh to shard the slot axis over
    mesh_axis: Optional[str] = None  # mesh axis name (slots % axis size == 0)
    # Plan and key-pack dispatch N+1 while the device runs dispatch N; the
    # plan sequence and the samples are unchanged.
    double_buffer: bool = True
    # Admission control: bounds on the live queue (requests / owed paths).
    max_queue_requests: Optional[int] = None
    max_queue_paths: Optional[int] = None
    # Signature coalescing: pad eligible fixed-grid requests up a
    # powers-of-two step ladder so horizons sharing a step size share a
    # bucket and stack into one dispatch; samples are unchanged.
    bucketing: bool = True
    bucket_min_steps: int = 8
    # Directory of the persistent kernel cache: kernel libraries are built
    # there and reloaded by later processes, so a restarted engine runs no
    # nvcc (the reference's persistent XLA compilation cache).
    compile_cache_dir: Optional[str] = None
    # Divergence guard threshold (None: off); flagged requests retry down
    # the retry_policy ladder (None: no retries).
    guard_threshold: Optional[float] = 1e6
    retry_policy: Optional[RetryPolicy] = RetryPolicy()
    # Supervised async serve loop: how many times a transient executor
    # crash may restart the loop before it fails the engine.
    max_restarts: int = 2


def _to_host(x) -> Optional[np.ndarray]:
    return None if x is None else x.cpu().numpy()


class SDESampleEngine:
    """Serve Monte-Carlo sampling requests against one SDE term.

    ``term``/``y0``/``args`` define the process (``args``, e.g. an
    ``nn.Module``, must live on ``device``, default ``"cuda"``); each
    request picks a solver from the registry by name and a horizon.
    Results come back as stacked numpy arrays per request id in ``done``.
    """

    def __init__(self, term, y0, cfg: SDESampleConfig = SDESampleConfig(),
                 args: Any = None, noise_shape=None, clock=None, device=None):
        if cfg.ticks_per_dispatch < 1:
            raise ValueError(
                f"ticks_per_dispatch must be >= 1, got {cfg.ticks_per_dispatch}"
            )
        if (cfg.mesh is None) != (cfg.mesh_axis is None):
            raise ValueError(
                "sharded serving needs mesh and mesh_axis together; pass "
                "both in SDESampleConfig (e.g. make_sample_mesh() + 'mc')"
            )
        if cfg.mesh is not None:
            from ..launch.mesh import axis_size

            axis = axis_size(cfg.mesh, cfg.mesh_axis)
            if cfg.slots % axis != 0:
                raise ValueError(
                    f"slots={cfg.slots} must be a multiple of mesh axis "
                    f"{cfg.mesh_axis!r} (size {axis}) to shard the slot axis"
                )
        self.device = resolve_device(device)
        self.term = term
        self.y0 = y0
        self.cfg = cfg
        self.args = args
        self.noise_shape = noise_shape
        if cfg.compile_cache_dir is not None:
            enable_persistent_compile_cache(cfg.compile_cache_dir)
        self._bucket_cfg = BucketingConfig(enabled=cfg.bucketing,
                                           min_steps=cfg.bucket_min_steps)
        self.scheduler = Scheduler(
            max_requests=cfg.max_queue_requests,
            max_paths=cfg.max_queue_paths,
            group_key=lambda sig: group_key(sig, self._bucket_cfg),
            clock=clock,
        )
        self.executor = TickExecutor(
            term, y0, args=args, noise_shape=noise_shape, dtype=cfg.dtype,
            mesh=cfg.mesh, mesh_axis=cfg.mesh_axis,
            guard=cfg.guard_threshold, device=self.device,
        )
        self._key_cache: Dict[int, torch.Tensor] = {}
        self._pad_key = PRNGKey(0, device=self.device)
        self._staged: Optional[Tuple[SlotPlan, torch.Tensor]] = None
        # Retry children run under negative internal ids and keep the root
        # request's seed, so a retried sample is exactly what submitting the
        # degraded spec directly would give.
        self._retry_ids = itertools.count(1)
        self._retry_parent: Dict[int, int] = {}   # child rid -> root rid
        self._retry_attempt: Dict[int, int] = {}  # root rid -> retries spent
        self._req_by_id: Dict[int, SampleRequest] = {}
        self._deadline: Dict[int, float] = {}     # root rid -> absolute s
        self.counters: Dict[str, int] = {
            "retries": 0, "timeouts": 0, "diverged_requests": 0,
            "diverged_paths": 0, "restarts": 0,
        }

    def _term_kind(self) -> str:
        """The solver kind the served term needs: ``"manifold"`` for a term
        with an ``algebra_increment`` (a ``ManifoldSDETerm``), else
        ``"euclidean"``."""
        return ("manifold" if hasattr(self.term, "algebra_increment")
                else "euclidean")

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def done(self) -> Dict[int, SampleResult]:
        return self.scheduler.done

    def submit(self, solver: str, *, t1: float, n_steps: int, n_paths: int,
               t0: float = 0.0, save_every: Optional[int] = None,
               seed: Optional[int] = None, rtol: Optional[float] = None,
               atol: Optional[float] = None, save_at=None,
               priority: int = 0,
               deadline_ms: Optional[float] = None) -> int:
        """Queue a sampling request; returns its request id.

        Arguments as for the reference engine's ``submit``: ``seed`` (default:
        the request id) keys path ``i`` as ``fold_in(PRNGKey(seed), i)``;
        ``priority`` reorders service, never samples; ``deadline_ms`` retires
        an undelivered request with ``timed_out=True``.  ``"auto"`` specs
        resolve here through ``select_solver`` (keys ``noise``, defaulting to
        the term's, and ``stiffness``; ``dt = (t1 - t0) / n_steps``).
        Malformed options raise here, never at the queue head;
        :class:`QueueFull` when admission control refuses the request.
        """
        if isinstance(solver, str):
            name, auto_kw = parse_solver_spec(solver)
            if name == "auto":
                unknown = set(auto_kw) - {"stiffness", "noise"}
                if unknown:
                    raise ValueError(
                        f"unknown option {sorted(unknown)[0]!r} for solver "
                        "'auto'; valid keys: noise, stiffness"
                    )
                auto_kw.setdefault(
                    "noise", getattr(self.term, "noise", "diagonal"))
                solver = select_solver(
                    dt=(t1 - t0) / max(int(n_steps), 1), **auto_kw)
        req = make_request(
            self.scheduler.next_request_id, solver, term_kind=self._term_kind(),
            t0=t0, t1=t1, n_steps=n_steps, n_paths=n_paths,
            save_every=save_every, seed=seed, rtol=rtol, atol=atol,
            save_at=save_at, priority=priority, deadline_ms=deadline_ms,
        )
        rid = self.scheduler.enqueue(req)
        self._req_by_id[rid] = req
        if deadline_ms is not None:
            self._deadline[rid] = self.scheduler.clock() + deadline_ms / 1e3
        return rid

    def pending(self, detail: bool = False) -> Dict[int, Any]:
        """Paths still owed per queued request id; ``detail=True`` gives
        per-request dicts plus the engine's ``"counters"``."""
        out = self.scheduler.pending(detail=detail)
        if detail:
            out["counters"] = dict(self.counters)
        return out

    def warmup(self, signatures) -> int:
        """Prepare the dispatch callables a list of requests needs.

        ``signatures`` are submit-style dicts (``solver``, ``t1``,
        ``n_steps`` and any of ``t0`` / ``save_every`` / ``rtol`` / ``atol``
        / ``save_at``; ``n_paths`` / ``seed`` / ``priority`` are ignored).
        Each resolves to its bucket (or exact signature) and is warmed at
        both dispatch depths the engine uses (``ticks_per_dispatch`` and the
        single-tick tail): the kernel libraries it launches are built — into
        ``compile_cache_dir`` when set, so later processes load them — its
        callable cached and, on the card, its tick graph captured at
        ``slots`` paths (the bucket's full-length tick; graphs are not
        cached across processes).  Returns the number of entries this call
        created (cached ones do not count)."""
        fresh = 0
        for spec in signatures:
            spec = dict(spec)
            for drop in ("n_paths", "seed", "priority"):
                spec.pop(drop, None)
            solver = spec.pop("solver")
            req = make_request(0, solver, term_kind=self._term_kind(),
                               n_paths=1, seed=0, **spec)
            key = bucket_key(req.signature, self._bucket_cfg)
            if key is None:
                key = req.signature
            for depth in {1, self.cfg.ticks_per_dispatch}:
                fresh += self.executor.warmup(key, depth, self.cfg.slots)
        return fresh

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued request (partial results discarded).  True if this
        call cancelled it; False if already cancelled or completed;
        ``KeyError`` on unknown ids.  A request mid-retry is cancellable by
        its root id."""
        target = request_id
        if (request_id in self._retry_attempt
                and request_id not in self.scheduler.done):
            for child, root in self._retry_parent.items():
                if root == request_id:
                    target = child
                    break
        cancelled = self.scheduler.cancel(target)
        if cancelled:
            self._key_cache.pop(target, None)
            self._req_by_id.pop(target, None)
            self._deadline.pop(request_id, None)
            self._retry_attempt.pop(request_id, None)
            if target != request_id:
                self._retry_parent.pop(target, None)
                self.scheduler._cancelled_ids.add(request_id)
        return cancelled

    # -- robustness ----------------------------------------------------------

    def _expire(self) -> list:
        """Retire queued requests whose deadline passed (a timed-out retry
        child resolves to its root id); returns the expired root ids."""
        roots = []
        for rid in self.scheduler.expire_deadlines():
            self.counters["timeouts"] += 1
            self._key_cache.pop(rid, None)
            self._req_by_id.pop(rid, None)
            root = self._retry_parent.pop(rid, rid)
            attempt = self._retry_attempt.pop(root, 0)
            self._deadline.pop(root, None)
            res = self.scheduler.done.pop(rid)
            self.scheduler.done[root] = dataclasses.replace(
                res, retries=attempt)
            roots.append(root)
        return roots

    def _make_retry(self, root: int, req: SampleRequest,
                    attempt: int) -> Optional[int]:
        """Enqueue the degraded resubmit of ``req``; None when no retry is
        possible (deadline spent, or the degraded spec does not validate)."""
        policy = self.cfg.retry_policy
        deadline_ms = None
        dl = self._deadline.get(root)
        if dl is not None:
            remaining = dl - self.scheduler.clock()
            if remaining <= 0:
                return None
            deadline_ms = remaining * 1e3
        overrides = policy.degrade(req, attempt)
        n_steps = overrides.get("n_steps", req.n_steps)
        save_every = req.save_every
        if save_every is not None and n_steps != req.n_steps:
            save_every = save_every * (n_steps // req.n_steps)
        child_id = -next(self._retry_ids)
        try:
            child = make_request(
                child_id, overrides.get("solver", req.solver),
                term_kind=self._term_kind(), t0=req.t0, t1=req.t1, n_steps=n_steps,
                n_paths=req.n_paths, save_every=save_every, seed=req.seed,
                rtol=req.rtol, atol=req.atol, save_at=req.save_at,
                priority=req.priority, deadline_ms=deadline_ms)
        except ValueError:
            return None
        self.scheduler.enqueue(child, force=True)
        self._req_by_id[child_id] = child
        self._retry_parent[child_id] = root
        self._retry_attempt[root] = attempt + 1
        self.counters["retries"] += 1
        return child_id

    def _finalize_retired(self, rid: int, diverged=None) -> Optional[int]:
        """Book divergence of a just-retired request, retry it or surface it
        under its root id; None when it went back on the queue.  ``diverged``
        is a host copy of the result's flags where those live on the device
        (the async engine's), read in their place."""
        res = self.scheduler.done[rid]
        root = self._retry_parent.get(rid, rid)
        attempt = self._retry_attempt.get(root, 0)
        if diverged is None:
            diverged = res.diverged
        n_div = 0
        if diverged is not None:
            n_div = int(diverged.sum())
        if n_div:
            self.counters["diverged_requests"] += 1
            self.counters["diverged_paths"] += n_div
        req = self._req_by_id.get(rid)
        if (n_div and self.cfg.retry_policy is not None and req is not None
                and attempt < self.cfg.retry_policy.max_retries
                and self._make_retry(root, req, attempt) is not None):
            del self.scheduler.done[rid]
            self._req_by_id.pop(rid, None)
            if rid != root:
                self._retry_parent.pop(rid, None)
            return None
        self._req_by_id.pop(rid, None)
        self._retry_attempt.pop(root, None)
        self._deadline.pop(root, None)
        if rid != root:
            self._retry_parent.pop(rid, None)
            res = self.scheduler.done.pop(rid)
            self.scheduler.done[root] = res
        if attempt:
            self.scheduler.done[root] = dataclasses.replace(
                self.scheduler.done[root], retries=attempt)
        return root

    # -- internals -----------------------------------------------------------

    def _request_keys(self, req: SampleRequest) -> torch.Tensor:
        """All of a request's path keys, ``fold_in(PRNGKey(seed), i)``, built
        once on the device."""
        keys = self._key_cache.get(req.request_id)
        if keys is None:
            keys = path_keys(PRNGKey(req.seed, device=self.device), req.n_paths)
            self._key_cache[req.request_id] = keys
        return keys

    def _plan_keys(self, plan: SlotPlan) -> torch.Tensor:
        """The ``(n_ticks, slots, 2)`` key stack of one dispatch, assembled
        on the device; unassigned slots get a dummy key (never read)."""
        buf = self._pad_key.expand(plan.n_ticks, plan.slots, 2).clone()
        for t, tick in enumerate(plan.ticks):
            s = 0
            while s < len(tick):  # contiguous (pending, path) runs -> slices
                p, i0 = tick[s]
                e = s + 1
                while e < len(tick) and tick[e][0] is p:
                    e += 1
                buf[t, s:e] = self._request_keys(p.request)[i0:i0 + (e - s)]
                s = e
        return buf

    def _split_subplans(self, plan: SlotPlan) -> list:
        """Split a plan shallower than ``ticks_per_dispatch`` into single
        ticks, so each (signature, depth) pair keeps one callable."""
        if plan.n_ticks in (1, self.cfg.ticks_per_dispatch):
            return [plan]
        return [SlotPlan(plan.tick_sigs[t] if plan.tick_sigs else
                         plan.signature, plan.slots, [tick],
                         reserved=plan.reserved, group=plan.group,
                         tick_sigs=(plan.tick_sigs[t],)
                         if plan.tick_sigs else None)
                for t, tick in enumerate(plan.ticks)]

    def _exec_key(self, plan: SlotPlan):
        """The plan's bucket when it was grouped into one, else its signature."""
        if isinstance(plan.group, BucketKey):
            return plan.group
        return plan.signature

    def _active_steps(self, plan: SlotPlan):
        """Each tick's true step count for a bucketed plan (None for exact)."""
        if not isinstance(plan.group, BucketKey):
            return None
        return tuple(sig[3] for sig in plan.tick_sigs)

    def _dispatch(self, plan: SlotPlan, keys):
        return self.executor.dispatch(self._exec_key(plan), keys,
                                      self._active_steps(plan))

    def _take_plan(self, depth: int):
        """The staged (plan, keys) when still live and within the tick
        budget, else a fresh reserved plan; fully-cancelled staged stacks
        are released, never dispatched."""
        while self._staged is not None:
            plan, keys = self._staged
            self._staged = None
            if not plan.live:
                self.scheduler.release(plan)
                continue
            if plan.n_ticks > depth:
                self.scheduler.release(plan)
                continue
            return plan, keys
        plan = self.scheduler.plan(self.cfg.slots, depth, reserve=True)
        if plan is None:
            return None, None
        return plan, self._plan_keys(plan)

    def _stage_next(self) -> None:
        """Plan and key-pack the next dispatch while the device still runs
        the current one (reservations keep the plan sequence unchanged)."""
        if self._staged is None:
            plan = self.scheduler.plan(self.cfg.slots,
                                       self.cfg.ticks_per_dispatch,
                                       reserve=True)
            if plan is not None:
                self._staged = (plan, self._plan_keys(plan))

    def _dispatch_next(self, tick_limit: int) -> int:
        """Plan (or unstage), dispatch and deliver one tick stack; returns
        the ticks served (0 when idle).  If a dispatch raises, every
        undelivered reservation is released before the error propagates."""
        self._expire()
        depth = min(tick_limit, self.cfg.ticks_per_dispatch)
        plan, keys = self._take_plan(depth)
        if plan is None:
            return 0
        subplans = self._split_subplans(plan)
        offset = 0
        delivered = 0
        try:
            for i, sp in enumerate(subplans):
                sp_keys = keys if len(subplans) == 1 else \
                    keys[offset:offset + sp.n_ticks]
                offset += sp.n_ticks
                result = self._dispatch(sp, sp_keys)
                if i == len(subplans) - 1 and self.cfg.double_buffer:
                    # The device is still integrating the stack just
                    # enqueued; overlap the next plan's host work with it.
                    self._stage_next()
                outputs = {"y_final": _to_host(result.y_final),
                           "ys": _to_host(result.ys)}
                for name in STAT_FIELDS:
                    outputs[name] = _to_host(getattr(result, name, None))
                for rid in self.scheduler.deliver(sp, outputs):
                    self._key_cache.pop(rid, None)
                    self._finalize_retired(rid)
                delivered += 1
        except BaseException:
            if self._staged is not None:
                staged_plan, _ = self._staged
                self._staged = None
                self.scheduler.release(staged_plan)
            residual = [tick for sp in subplans[delivered:]
                        for tick in sp.ticks]
            if residual:
                self.scheduler.release(SlotPlan(
                    plan.signature, plan.slots, residual, reserved=True,
                    group=plan.group))
            raise
        return plan.n_ticks

    def tick(self) -> bool:
        """Serve one dispatch (up to ``ticks_per_dispatch`` ticks); False
        when idle."""
        return self._dispatch_next(self.cfg.ticks_per_dispatch) > 0

    def run(self, max_ticks: int = 10_000) -> Dict[int, SampleResult]:
        """Serve until the queue drains (or ``max_ticks`` ticks ran)."""
        served = 0
        while served < max_ticks:
            n = self._dispatch_next(max_ticks - served)
            if n == 0:
                return self.done
            served += n
        if self.pending():
            raise RuntimeError(
                f"max_ticks={max_ticks} exhausted with {len(self.pending())} "
                "request(s) still queued; raise max_ticks or slots"
            )
        return self.done
