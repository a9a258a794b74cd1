"""Host-side serving scheduler: FIFO queue, signature grouping, slot plans.

Port of ``repro.serving.scheduler``: pure Python, kept as its own copy (the
port imports nothing of the reference) with the same messages and the same
plan sequence, so the two engines serve the same paths in the same slots.

This is the pure-Python half of the SDE serving core (the device half is
:mod:`repro_torch.serving.executor`; :class:`repro_torch.serving.SDESampleEngine` is the
façade over both).  The scheduler owns everything that does NOT need a
device — and is therefore unit-testable without one:

* the FIFO request queue and the ``done`` result store;
* request validation at submit time (:func:`make_request`), so a bad spec
  can never crash at the queue head and starve the requests behind it;
* **slot-plan construction** (:meth:`Scheduler.plan`): fill up to
  ``max_ticks`` fixed-size ticks of ``slots`` paths each with paths from
  queued requests sharing the head request's *signature* — FIFO over
  requests, contiguous over each request's path indices.  Within that
  signature group, planning ``T`` ticks at once is allocation-for-allocation
  identical to planning one tick ``T`` times (the cursor arithmetic is the
  same), which is what lets the executor run the whole stack in one
  on-device loop without changing which path lands in which slot.  Across
  signatures the stack widens the continuous-batching window: a deeper
  dispatch may finish a later same-signature request before an earlier
  different-signature one gets its first tick — the same
  group-by-signature policy the single-tick engine already applied within
  one tick, extended over ``ticks_per_dispatch`` ticks.  Service *order*
  (and latency) across signatures therefore depends on the dispatch depth;
  the delivered samples never do;
* **result scatter and retirement** (:meth:`Scheduler.deliver`): route each
  slot of each tick back to its request, retire fully-served requests into
  ``done`` in queue order;
* cancellation (lazy — a cancelled entry is skipped by the planner and
  pruned from the queue on the next plan, so ``cancel`` is O(1)) and
  :meth:`Scheduler.pending` introspection for polling clients;
* **priority classes**: every request carries a ``priority`` (higher is
  served sooner); planning walks the queue in *service order* — a stable
  sort by descending priority, so equal priorities keep strict FIFO and the
  default ``priority=0`` workload behaves exactly as before.  Priority only
  reorders *when* a request is served, never *what* it receives (samples are
  a pure function of ``(seed, path index)``);
* **admission control**: optional ``max_requests`` / ``max_paths`` bounds
  turn :meth:`Scheduler.enqueue` into a bounded queue that raises
  :class:`QueueFull` instead of growing without limit — the hook the async
  engine's backpressure (``await submit``) and a sync caller's load shedding
  both build on;
* **plan-ahead reservations** (:meth:`Scheduler.plan` with
  ``reserve=True``): a reserved plan marks its paths in flight so the *next*
  plan starts beyond them — this is what lets an engine build and stage
  stack N+1 while the device still runs stack N (host-side double
  buffering).  Reserved plans must be delivered in the order they were
  planned; an undispatched reserved plan can be returned via
  :meth:`Scheduler.release` (LIFO — newest first), e.g. when every request
  in a staged stack was cancelled before its dispatch.

The scheduler never touches a PRNG key: a plan names ``(request, path
index)`` pairs, and sampling reproducibility comes from the engine mapping
pair ``(r, i)`` to ``fold_in(PRNGKey(seed_r), i)`` — independent of slot
assignment, tick boundaries, dispatch grouping, device placement, priority
ordering, and double buffering.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core.registry import canonical_spec, parse_solver_spec, solver_kind

__all__ = [
    "QueueFull",
    "RetryPolicy",
    "SampleRequest",
    "SampleResult",
    "PendingRequest",
    "SlotPlan",
    "Scheduler",
    "make_request",
]


class QueueFull(RuntimeError):
    """Admission control refused a submit: the bounded queue is at capacity.

    Sync callers should shed load (or retry later); the async engine's
    ``await submit`` catches this and waits for space instead."""

# Per-path statistics riding along with every delivery: the adaptive
# controller stats plus the per-path blow-up flag from the in-loop guard
# (``diverged`` — produced whenever the engine's guard is enabled, for
# fixed-grid and adaptive requests alike; None when the guard is off).
STAT_FIELDS = ("t_final", "n_accepted", "n_rejected", "diverged")


@dataclasses.dataclass(frozen=True)
class SampleRequest:
    request_id: int
    solver: str
    t0: float
    t1: float
    n_steps: int
    n_paths: int
    save_every: Optional[int]
    seed: int
    # Adaptive-solve options (solver spec carries an "adaptive" flag):
    # tolerances for the PI controller and an arbitrary-time output grid.
    rtol: Optional[float] = None
    atol: Optional[float] = None
    save_at: Optional[Tuple[float, ...]] = None
    # Service-order class: higher priorities are planned sooner; equal
    # priorities keep strict FIFO.  Never part of the signature — priority
    # says when a request runs, not what executable runs it.
    priority: int = 0
    # Wall-clock budget: paths not delivered within deadline_ms of submit
    # retire with a timeout result (sync) / a TimeoutError (async).  Never
    # part of the signature — a deadline says how long a request may wait,
    # not what executable runs it.
    deadline_ms: Optional[float] = None

    @property
    def signature(self) -> Tuple:
        """Requests with equal signatures can share one compiled batch."""
        return (self.solver, self.t0, self.t1, self.n_steps, self.save_every,
                self.rtol, self.atol, self.save_at)


@dataclasses.dataclass
class SampleResult:
    """Stacked per-path outputs: ``y_final`` is (n_paths, ...); ``ys`` is
    (n_paths, n_saves, ...) when the request asked for a saved trajectory.

    ``t_final`` (adaptive requests only) is the (n_paths,) time each path
    actually reached — equal to the request's ``t1`` unless the trial-step
    budget ``n_steps`` was exhausted first, in which case the path stopped
    short and its ``y_final`` is NOT a sample at ``t1``.  Check it (or just
    ``(t_final == t1).all()``) before trusting adaptive results from
    aggressive tolerance/budget combinations.

    ``n_accepted`` / ``n_rejected`` (adaptive requests only) are the
    per-path realized-grid statistics: how many steps each path's controller
    accepted/rejected — the realized grid a client would replay offline (via
    ``realize_grid`` with the same seed-derived key) for gradient work.

    ``diverged`` (guard-enabled engines) is the (n_paths,) per-path blow-up
    flag from the in-loop divergence guard: True where a path's state went
    non-finite or exceeded the guard threshold at any step.  The samples are
    whatever the solver computed (the guard is a pure observer); treat
    flagged paths as unusable.  None when the guard is off.

    ``timed_out`` marks a request whose ``deadline_ms`` elapsed before
    delivery: its arrays are None and it retired with a timeout state
    instead of samples.  ``retries`` counts degradation-ladder resubmits the
    engine spent on this request (0 for a first-attempt completion; see
    :class:`RetryPolicy`).

    ``bucket`` / ``n_padded_steps`` / ``n_padded_paths`` surface bucketed
    dispatch (PR 8) for operators watching padding waste: ``bucket`` is the
    :class:`~repro_torch.serving.bucketing.BucketKey` this request was coalesced
    into (None when it dispatched exact), ``n_padded_steps`` how many masked
    padding steps its executable carried beyond the request's true
    ``n_steps``, and ``n_padded_paths`` how many dead (dummy-key) slots rode
    along in the ticks that served it.  Padding never changes the samples —
    padding steps are skipped conditionals and dead slots are dropped before
    scatter — these fields only quantify the compute the coalescing spent to
    share an executable."""

    y_final: Any
    ys: Optional[Any]
    t_final: Optional[np.ndarray] = None
    n_accepted: Optional[np.ndarray] = None
    n_rejected: Optional[np.ndarray] = None
    diverged: Optional[np.ndarray] = None
    bucket: Any = None
    n_padded_steps: int = 0
    n_padded_paths: int = 0
    timed_out: bool = False
    retries: int = 0


@dataclasses.dataclass(eq=False)  # identity hash: instances are queue entries
class PendingRequest:
    request: SampleRequest
    delivered: int = 0
    # Paths named by a not-yet-delivered *reserved* plan (see Scheduler.plan
    # with reserve=True): planning starts beyond delivered + reserved, so a
    # staged stack and the live one never overlap.
    reserved: int = 0
    cancelled: bool = False
    # Bucketing introspection (set when the request is first planned /
    # delivered; see SampleResult for the field semantics).
    bucket: Any = None
    n_padded_steps: int = 0
    n_padded_paths: int = 0
    # Absolute wall-clock deadline (scheduler-clock seconds) when the
    # request carries deadline_ms; set at enqueue time.
    deadline: Optional[float] = None
    y_final: List[np.ndarray] = dataclasses.field(default_factory=list)
    ys: List[np.ndarray] = dataclasses.field(default_factory=list)
    t_final: List[np.ndarray] = dataclasses.field(default_factory=list)
    n_accepted: List[np.ndarray] = dataclasses.field(default_factory=list)
    n_rejected: List[np.ndarray] = dataclasses.field(default_factory=list)
    diverged: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def remaining(self) -> int:
        return self.request.n_paths - self.delivered

    def n_diverged(self) -> int:
        """Delivered paths flagged by the blow-up guard so far.  Each entry
        is one path's scalar flag; async deliveries keep them device-resident
        until materialised, so this forces a transfer of tiny bools only."""
        return int(sum(bool(np.asarray(d)) for d in self.diverged))


@dataclasses.dataclass
class SlotPlan:
    """One dispatch: up to ``max_ticks`` same-*group* ticks of ``slots``
    paths each.  ``ticks[t][s]`` names the (pending, path-index) pair that
    owns slot ``s`` of tick ``t``; trailing slots of a tick may be unassigned
    (the engine pads them with dummy keys and the planner never references
    their outputs).  ``reserved`` plans hold their paths in flight until
    delivered (or released) — see :meth:`Scheduler.plan`.

    Without bucketing a group IS one signature and every tick shares it.
    Under a bucketed group several *true* signatures (same bucket, different
    horizons) may stack into one plan: each **tick** stays homogeneous in
    true signature — ``tick_sigs[t]`` names tick ``t``'s — because the
    executor's per-tick ``active_steps`` operand is one scalar per tick.
    ``group`` carries the planning-group key (a
    :class:`~repro_torch.serving.bucketing.BucketKey` for bucketed plans);
    ``signature`` remains the first tick's true signature for single-
    signature consumers."""

    signature: Tuple
    slots: int
    ticks: List[List[Tuple[PendingRequest, int]]]
    reserved: bool = False
    group: Any = None
    tick_sigs: Optional[Tuple[Tuple, ...]] = None

    @property
    def n_ticks(self) -> int:
        return len(self.ticks)

    @property
    def n_paths(self) -> int:
        return sum(len(t) for t in self.ticks)

    @property
    def live(self) -> bool:
        """False once every owning request was cancelled — a dead stack an
        engine should skip (releasing it) instead of dispatching no-ops."""
        return any(not p.cancelled for tick in self.ticks for p, _ in tick)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Degradation ladder for diverged requests (see ``docs/robustness.md``).

    A request whose delivered paths carry any guard ``diverged`` flag is
    resubmitted by the engine down a two-stage ladder, at most
    ``max_retries`` times total:

    1. the first ``max_h_halvings`` retries **halve the step size** — same
       solver, ``n_steps`` doubled over the same window (for adaptive
       requests this doubles the trial-step budget);
    2. further retries **fall back** to ``fallback_solver`` (``ees27`` — the
       paper's widest-stability-region explicit scheme), preserving the
       request's adaptive flag; if the request already runs the fallback
       family, the ladder keeps halving instead.

    Retries reuse the root request's seed, so a retried sample is exactly
    what submitting the degraded spec directly would have produced —
    reproducible, and bitwise-independent of when the retry happened."""

    max_retries: int = 2
    max_h_halvings: int = 1
    fallback_solver: str = "ees27"

    def degrade(self, request: "SampleRequest", attempt: int) -> Dict[str, Any]:
        """Spec overrides for retry number ``attempt`` (0-based): a dict of
        ``make_request`` keyword overrides (``solver`` / ``n_steps``)."""
        base, opts = parse_solver_spec(request.solver)
        fb = canonical_spec(self.fallback_solver)
        fb_base, _ = parse_solver_spec(fb)
        if attempt < self.max_h_halvings or base == fb_base:
            return {"solver": request.solver, "n_steps": request.n_steps * 2}
        solver = self.fallback_solver
        if opts.get("adaptive", False):
            solver = f"{solver}:adaptive"
        return {"solver": canonical_spec(solver), "n_steps": request.n_steps}


def make_request(request_id: int, solver: str, *, term_kind: str, t1: float,
                 n_steps: int, n_paths: int, t0: float = 0.0,
                 save_every: Optional[int] = None, seed: Optional[int] = None,
                 rtol: Optional[float] = None, atol: Optional[float] = None,
                 save_at=None, priority: int = 0,
                 deadline_ms: Optional[float] = None) -> SampleRequest:
    """Validate request options and build a :class:`SampleRequest`.

    Raises on anything malformed — this runs at submit time, not at the
    queue head where a crash would starve everything queued behind it.
    ``term_kind`` is the solver kind the serving term needs (``"euclidean"``
    or ``"manifold"``); the solver spec must match.
    """
    if n_paths < 1:
        raise ValueError(f"n_paths must be >= 1, got {n_paths}")
    n_steps = int(n_steps)
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if not float(t1) > float(t0):
        raise ValueError(f"need t1 > t0, got t0={t0}, t1={t1}")
    solver = canonical_spec(solver)  # raises on unknown names; one
    # normal form per solver so equivalent spellings share a signature
    if solver_kind(solver) != term_kind:
        raise ValueError(
            f"solver {solver!r} is {solver_kind(solver)}-kind but this "
            f"engine's term needs a {term_kind} solver"
        )
    adaptive = parse_solver_spec(solver)[1].get("adaptive", False)
    if not adaptive:
        for name, val in (("rtol", rtol), ("atol", atol), ("save_at", save_at)):
            if val is not None:
                raise ValueError(
                    f"{name} only applies to adaptive solves; request an "
                    f"':adaptive' solver spec (got {solver!r})"
                )
    if adaptive and save_every is not None:
        raise ValueError(
            "save_every indexes a fixed grid; adaptive requests take "
            "save_at=<sequence of times> instead"
        )
    if save_at is not None:
        try:
            save_at = tuple(float(t) for t in save_at)
        except (TypeError, ValueError):
            # A 2-D array, complex dtype, strings, ... must die HERE with the
            # argument named, not as a dtype error inside jit at the queue
            # head.
            raise ValueError(
                "save_at must be a flat sequence of real (float-convertible) "
                f"times, got {save_at!r}"
            ) from None
        if not save_at:
            raise ValueError("save_at must be a non-empty sequence of times")
        if not all(float(t0) <= t <= float(t1) for t in save_at):
            raise ValueError(f"save_at times must lie in [{t0}, {t1}]")
    if save_every is not None:
        if int(save_every) != save_every or int(save_every) < 1:
            raise ValueError(f"save_every must be a positive int, got {save_every}")
        save_every = int(save_every)
        if n_steps % save_every != 0:
            raise ValueError(
                f"save_every={save_every} does not divide n_steps={n_steps}"
            )
    if int(priority) != priority:
        raise ValueError(f"priority must be an int, got {priority!r}")
    if deadline_ms is not None:
        deadline_ms = float(deadline_ms)
        if not deadline_ms > 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
    return SampleRequest(
        request_id=request_id, solver=solver, t0=float(t0), t1=float(t1),
        n_steps=n_steps, n_paths=int(n_paths), save_every=save_every,
        seed=request_id if seed is None else int(seed),
        rtol=None if rtol is None else float(rtol),
        atol=None if atol is None else float(atol),
        save_at=save_at,
        priority=int(priority),
        deadline_ms=deadline_ms,
    )


class Scheduler:
    """Priority-FIFO scheduler over :class:`PendingRequest` entries (host-side
    only).  ``max_requests`` / ``max_paths`` bound the live queue (admission
    control): an :meth:`enqueue` that would exceed either raises
    :class:`QueueFull` without enqueueing.

    ``group_key`` maps a request signature to its *planning group* — the
    unit :meth:`plan` fills a dispatch from.  The default (identity) keeps
    the classic one-signature-per-plan behaviour; the bucketing layer passes
    :func:`repro_torch.serving.bucketing.group_key` so signatures sharing a padded
    bucket plan together (see :class:`SlotPlan` for the per-tick homogeneity
    contract)."""

    def __init__(self, max_requests: Optional[int] = None,
                 max_paths: Optional[int] = None, group_key=None, clock=None):
        self.queue: Deque[PendingRequest] = deque()
        self.done: Dict[int, SampleResult] = {}
        self.max_requests = max_requests
        self.max_paths = max_paths
        self.group_key = group_key if group_key is not None else (lambda sig: sig)
        # Deadline clock: monotonic seconds.  Injectable (fault-injection
        # tests pass a FakeClock) so deadline behaviour is deterministic.
        self.clock = clock if clock is not None else time.monotonic
        self._next_id = 0
        self._cancelled_ids: set = set()

    @property
    def next_request_id(self) -> int:
        """The id the next enqueued request will get.  Reading it does not
        allocate: build (and validate) the request against this id first, so
        a rejected submit burns no id and leaves default seeds (= request
        id) of later requests unshifted."""
        return self._next_id

    def new_request_id(self) -> int:
        rid = self._next_id
        self._next_id += 1
        return rid

    def enqueue(self, request: SampleRequest, *, force: bool = False) -> int:
        """Admit ``request`` into the queue (raising :class:`QueueFull` at
        capacity).  ``force=True`` bypasses admission control — reserved for
        the engine's internal retry resubmits, which replace capacity an
        earlier admit already granted and must never be refused (a refused
        retry would strand its waiter)."""
        live = [p for p in self.queue if not p.cancelled]
        if (not force and self.max_requests is not None
                and len(live) + 1 > self.max_requests):
            raise QueueFull(
                f"queue holds {len(live)} live request(s); admission limit is "
                f"max_requests={self.max_requests} — drain, cancel, or raise "
                "the limit (the async engine awaits space instead)"
            )
        if not force and self.max_paths is not None:
            owed = sum(p.remaining for p in live)
            if owed + request.n_paths > self.max_paths:
                raise QueueFull(
                    f"queue owes {owed} path(s) and this request adds "
                    f"{request.n_paths}; admission limit is max_paths="
                    f"{self.max_paths}"
                )
        self._next_id = max(self._next_id, request.request_id + 1)
        entry = PendingRequest(request)
        if request.deadline_ms is not None:
            entry.deadline = self.clock() + request.deadline_ms / 1e3
        self.queue.append(entry)
        return request.request_id

    # -- introspection / cancellation ---------------------------------------

    def pending(self, detail: bool = False) -> Dict[int, Any]:
        """Paths still owed per queued request id (FIFO order, cancelled
        entries excluded) — what a polling client checks between ``run``s.

        ``detail=True`` returns a dict per request instead of a bare count:
        ``remaining`` plus the bucketing introspection — ``bucket`` (the
        :class:`~repro_torch.serving.bucketing.BucketKey` the request coalesced
        into once planned; None before planning or for exact dispatch),
        ``n_padded_steps`` (masked padding steps its bucket executable
        carries beyond the true ``n_steps``) and ``n_padded_paths`` (dead
        slots that rode along in its delivered ticks so far) — plus the
        robustness fields: ``n_diverged`` (delivered paths flagged by the
        blow-up guard so far) and ``deadline_remaining_s`` (seconds until
        this request's deadline expires; None without a deadline)."""
        if not detail:
            return {p.request.request_id: p.remaining
                    for p in self.queue if not p.cancelled}
        now = self.clock()
        return {p.request.request_id: {
                    "remaining": p.remaining,
                    "bucket": p.bucket,
                    "n_padded_steps": p.n_padded_steps,
                    "n_padded_paths": p.n_padded_paths,
                    "n_diverged": p.n_diverged(),
                    "deadline_remaining_s": (
                        None if p.deadline is None
                        else max(0.0, p.deadline - now)),
                }
                for p in self.queue if not p.cancelled}

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued request; partial results are discarded.

        Returns True if this call cancelled it, False if it was already
        cancelled or already completed (``done`` keeps completed results —
        cancellation never un-delivers).  Unknown ids raise ``KeyError``.
        O(1) effect: the entry is only marked here and pruned by the next
        :meth:`plan`, so an idle engine never spins over cancelled husks.
        """
        if request_id in self.done:
            return False
        if request_id in self._cancelled_ids:
            return False  # repeat cancel, incl. after plan() pruned the entry
        for p in self.queue:
            if p.request.request_id == request_id:
                p.cancelled = True
                self._cancelled_ids.add(request_id)
                return True
        raise KeyError(f"unknown request id {request_id}")

    def expire_deadlines(self, now: Optional[float] = None) -> List[int]:
        """Retire every queued request whose deadline has passed.

        Each expired request is cancelled in place (same lazy mechanism as
        :meth:`cancel` — partial results drop, the planner prunes the husk)
        and a timeout :class:`SampleResult` (``timed_out=True``, no arrays)
        lands in ``done`` so pollers and waiters observe a terminal state
        instead of a vanished id.  Returns the expired ids, FIFO order.
        Engines call this once per dispatch cycle; ``now`` overrides the
        scheduler clock (tests)."""
        now = self.clock() if now is None else now
        expired: List[int] = []
        for p in self.queue:
            if p.cancelled or p.deadline is None or now < p.deadline:
                continue
            rid = p.request.request_id
            p.cancelled = True
            self._cancelled_ids.add(rid)
            self.done[rid] = SampleResult(y_final=None, ys=None,
                                          timed_out=True)
            expired.append(rid)
        return expired

    # -- planning -----------------------------------------------------------

    def _service_order(self) -> List[PendingRequest]:
        """Live queue entries in service order: a *stable* sort by descending
        priority, so equal priorities (incl. the default 0) keep strict FIFO
        and the all-default workload plans exactly as the plain FIFO did."""
        return sorted((p for p in self.queue if not p.cancelled),
                      key=lambda p: -p.request.priority)

    @staticmethod
    def _unplanned(p: PendingRequest) -> int:
        return p.request.n_paths - p.delivered - p.reserved

    def signatures(self) -> List[Tuple[Tuple, int]]:
        """Unique signatures with plannable (live, unreserved) work, in
        service order, each with the best priority among its requests."""
        out: List[Tuple[Tuple, int]] = []
        seen = set()
        for p in self._service_order():
            if self._unplanned(p) <= 0:
                continue
            sig = p.request.signature
            if sig not in seen:
                seen.add(sig)
                out.append((sig, p.request.priority))
        return out

    def groups(self) -> List[Tuple[Any, int]]:
        """Unique *planning groups* with plannable work, in service order,
        each with the best priority among its requests — what an
        interleaving serve loop round-robins over.  With the identity
        ``group_key`` this is exactly :meth:`signatures`; with bucketing the
        list is shorter (bucketed signatures merge)."""
        out: List[Tuple[Any, int]] = []
        seen = set()
        for p in self._service_order():
            if self._unplanned(p) <= 0:
                continue
            g = self.group_key(p.request.signature)
            if g not in seen:
                seen.add(g)
                out.append((g, p.request.priority))
        return out

    def plan(self, slots: int, max_ticks: int = 1, *,
             signature: Optional[Tuple] = None,
             group: Any = None,
             reserve: bool = False) -> Optional[SlotPlan]:
        """Build the next dispatch: up to ``max_ticks`` ticks of one
        planning group, or None when no plannable work is queued.

        Prunes cancelled entries first (their partial results are dropped),
        then fills tick after tick over the chosen group exactly as
        successive single-tick plans over that group would — multi-tick
        dispatch never changes *which* path runs in which slot.  It can
        change cross-group service order: the stack keeps draining one
        group, so an other-group request queued in between waits for the
        next dispatch (see the module docstring).

        Within a group, ticks fill **one true signature at a time** in
        service order of each signature's first plannable request, FIFO over
        requests within a signature, contiguous over each request's path
        indices; a tick never mixes signatures (the bucket executable takes
        one ``active_steps`` scalar per tick), so switching signature closes
        the current tick even if slots remain.  With the identity
        ``group_key`` a group holds exactly one signature and this reduces
        verbatim to the classic filling.

        ``group`` pins the planning group (an interleaving serve loop
        round-robins :meth:`groups`); ``signature`` pins the group *through*
        a signature (kept for single-signature callers — it resolves to
        ``group_key(signature)``).  By default the group of the first
        plannable request in service order — highest priority, then FIFO —
        is drained.

        ``reserve=True`` marks the planned paths in flight, so a later
        ``plan`` call (before this one is delivered) starts beyond them —
        the double-buffering hook.  Reserved plans must be **delivered in
        planning order** (path scatter is ordered per request); an
        undispatched reserved plan is returned via :meth:`release`, newest
        first.
        """
        if any(p.cancelled for p in self.queue):
            live = [p for p in self.queue if not p.cancelled]
            # prune in place: the queue object is a stable view (the engine
            # façade exposes it), so rebinding would strand held references
            self.queue.clear()
            self.queue.extend(live)
        if signature is not None and group is not None:
            raise ValueError("pass signature= or group=, not both")
        order = self._service_order()
        if signature is not None:
            group = self.group_key(signature)
        if group is None:
            for p in order:
                if self._unplanned(p) > 0:
                    group = self.group_key(p.request.signature)
                    break
        if group is None:
            return None
        # Members of the group, bucketed by true signature in service order
        # of first appearance (each tick must stay signature-homogeneous).
        by_sig: Dict[Tuple, List[PendingRequest]] = {}
        sig_order: List[Tuple] = []
        for p in order:
            sig = p.request.signature
            if self.group_key(sig) != group:
                continue
            if sig not in by_sig:
                by_sig[sig] = []
                sig_order.append(sig)
            by_sig[sig].append(p)
        taken: Dict[PendingRequest, int] = {}
        ticks: List[List[Tuple[PendingRequest, int]]] = []
        tick_sigs: List[Tuple] = []
        for sig in sig_order:
            while len(ticks) < max_ticks:
                tick: List[Tuple[PendingRequest, int]] = []
                budget = slots
                for p in by_sig[sig]:
                    if budget == 0:
                        break
                    start = p.delivered + p.reserved + taken.get(p, 0)
                    take = min(budget, p.request.n_paths - start)
                    tick.extend((p, start + j) for j in range(take))
                    if take:
                        taken[p] = taken.get(p, 0) + take
                        budget -= take
                if not tick:
                    break  # this signature exhausted; move to the next
                ticks.append(tick)
                tick_sigs.append(sig)
            if len(ticks) >= max_ticks:
                break
        if not ticks:
            return None
        if reserve:
            for p, n in taken.items():
                p.reserved += n
        # Introspection: record the bucket (duck-typed — only bucket groups
        # carry an n_padded rung) on every request the plan touches.
        n_padded = getattr(group, "n_padded", None)
        if n_padded is not None:
            for p in taken:
                p.bucket = group
                p.n_padded_steps = n_padded - p.request.n_steps
        return SlotPlan(signature=tick_sigs[0], slots=slots, ticks=ticks,
                        reserved=reserve, group=group,
                        tick_sigs=tuple(tick_sigs))

    def release(self, plan: SlotPlan) -> None:
        """Return an undispatched *reserved* plan's paths to the queue.

        Only valid LIFO — release the most recently planned outstanding
        reservation first — because planning cursors grow past every live
        reservation: releasing an older plan while a newer one still holds
        later paths would let the next plan re-issue the newer plan's work.
        The engine only ever stages (and therefore releases) the newest plan.
        """
        if not plan.reserved:
            raise ValueError("release() takes a plan built with reserve=True")
        counts: Dict[PendingRequest, int] = {}
        for tick in plan.ticks:
            for p, _ in tick:
                counts[p] = counts.get(p, 0) + 1
        for p, n in counts.items():
            p.reserved -= n  # cancelled husks unwind too; harmless

    # -- delivery -----------------------------------------------------------

    def deliver(self, plan: SlotPlan,
                outputs: Dict[str, Optional[np.ndarray]],
                *, stack=np.stack) -> List[int]:
        """Scatter dispatch outputs back to their requests and retire.

        ``outputs`` maps field name (``y_final`` / ``ys`` / the adaptive
        stats) to a stacked array with leading ``(n_ticks, slots)`` axes, or
        None for fields this signature does not produce.  Returns the ids
        retired into ``done``, in service order.  ``stack`` builds each
        retired result's per-request arrays — ``np.stack`` (default) lands
        results on the host; the async engine passes ``jnp.stack`` so
        results stay device-resident until the caller materialises them.
        """
        for t, tick in enumerate(plan.ticks):
            dead = plan.slots - len(tick)
            for p in dict.fromkeys(p for p, _ in tick):
                p.n_padded_paths += dead
            for s, (p, i) in enumerate(tick):
                if i != p.delivered:  # pragma: no cover — planner invariant
                    raise RuntimeError(
                        f"plan slot (tick {t}, slot {s}) delivers path {i} of "
                        f"request {p.request.request_id} but {p.delivered} "
                        "paths were delivered so far — out-of-order delivery"
                    )
                p.y_final.append(outputs["y_final"][t, s])
                if outputs.get("ys") is not None:
                    p.ys.append(outputs["ys"][t, s])
                for name in STAT_FIELDS:
                    if outputs.get(name) is not None:
                        getattr(p, name).append(outputs[name][t, s])
                p.delivered += 1
                if plan.reserved:
                    p.reserved -= 1
        retired = []
        for p in dict.fromkeys(p for tick in plan.ticks for p, _ in tick):
            if p.delivered == p.request.n_paths and not p.cancelled:
                self.queue.remove(p)
                rid = p.request.request_id
                self.done[rid] = SampleResult(
                    y_final=stack(p.y_final),
                    ys=stack(p.ys) if p.ys else None,
                    bucket=p.bucket,
                    n_padded_steps=p.n_padded_steps,
                    n_padded_paths=p.n_padded_paths,
                    **{name: (stack(getattr(p, name))
                              if getattr(p, name) else None)
                       for name in STAT_FIELDS},
                )
                retired.append(rid)
        return retired
