"""Async continuous-batching serving plane over the scheduler/executor core.

Port of ``repro.serving.async_engine``.  :class:`AsyncSDESampleEngine` is the
event-loop counterpart of the synchronous
:class:`~repro_torch.serving.sde_engine.SDESampleEngine`: the same host-side
:class:`~repro_torch.serving.scheduler.Scheduler` and device-side
:class:`~repro_torch.serving.executor.TickExecutor` underneath, driven by one
asyncio serve task that keeps the device busy on a *continuous*
mixed-signature request stream instead of drain-style ``run()`` calls:

* **Awaitable API** — ``rid = await eng.submit(...)`` and
  ``res = await eng.result(rid)``.  ``submit`` applies admission control
  with *backpressure*: when the bounded queue (``max_queue_requests`` /
  ``max_queue_paths``) is full it waits for space instead of raising the
  :class:`~repro_torch.serving.scheduler.QueueFull` a sync ``submit`` sees.
* **Cross-signature interleaving** — the serve loop round-robins stacks
  across the planning groups of the best pending priority class, so a long
  homogeneous burst cannot starve another group of its first tick.
* **Host-side double buffering** — a dispatch enqueues device work and
  returns, so right after stack N is handed to the device the loop scatters
  N's results lazily (device views) and plans and key-packs stack N+1 while
  the device integrates.  At most two dispatches are in flight: before N+2
  the loop waits, off-thread, for N's ``landing`` event (a ``torch.cuda``
  event the executor records on its stream), which keeps the event loop
  responsive for submitters.
* **Device-resident results** — delivery stacks dispatch outputs with
  ``torch.stack`` on the device; nothing is copied to the host unless the
  caller asks (``await eng.result(rid, numpy=True)``, copied off-thread).
* **Robustness** — retirement and *finalization* are split: a retired
  request's divergence flags are read (and its retry-vs-surface decision
  made) only when the serve loop next lands a stack, so the blow-up guard
  adds no host sync to the dispatch path.  Deadlines wake their ``result``
  waiters with ``TimeoutError``; a *transient* executor crash (e.g. an
  injected fault, :mod:`repro_torch.serving.faults`) restarts the serve loop
  under supervision, at most ``SDESampleConfig.max_restarts`` times, and
  because async plans are unreserved and delivery is atomic per subplan the
  replan serves exactly the undelivered ticks.

A first dispatch of a (signature-or-bucket, depth), and on the card any
dispatch that captures a tick graph (``has_compiled`` with its live-step
counts), runs in a worker thread (``asyncio.to_thread``), as in the
reference, since it may pay the kernel libraries' build and the capture;
the executor fixes grad mode and the CUDA stream inside
every dispatch, so a worker thread serves exactly as the loop thread does.
Samples are pure functions of ``(seed, path index)``, so the async plane
returns results bitwise equal to ``SDESampleEngine.run()`` on the same
requests, across dispatch depths, priorities and interleavings.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Dict, List, Optional

import torch

from .scheduler import STAT_FIELDS, QueueFull, SampleResult
from .sde_engine import SDESampleConfig, SDESampleEngine

__all__ = ["AsyncSDESampleEngine"]


async def _landed(event: Optional[torch.cuda.Event]) -> None:
    """Wait off-thread until ``event`` completed (nothing to wait for off
    CUDA, where ``event`` is None: the work already ran)."""
    if event is not None:
        await asyncio.to_thread(event.synchronize)


class AsyncSDESampleEngine:
    """Serve a continuous stream of Monte-Carlo sampling requests.

    Construction mirrors :class:`SDESampleEngine` (``term``/``y0`` define the
    process; :class:`SDESampleConfig` sizes the plane — ``max_queue_paths``
    turns ``submit`` backpressure on; ``clock`` overrides the deadline clock;
    ``device`` defaults to ``"cuda"``).  Use as an async context manager, or
    call :meth:`close`::

        async with AsyncSDESampleEngine(term, y0, cfg, args=model) as eng:
            rid = await eng.submit("ees25", t1=1.0, n_steps=32, n_paths=4096)
            res = await eng.result(rid)        # device tensors

    The serve task starts with the first ``submit`` and idles (no polling,
    no device work) whenever the queue is empty.

    With ``cfg.mesh`` each rank runs its own engine, and each rank's serve
    loop plans from its own queue: every rank must submit the same requests
    in the same order between the same awaits (a ``submit`` that does not
    wait for queue space does not yield to the serve loop), so that every
    rank plans the same ticks and their collectives pair up.
    """

    def __init__(self, term, y0, cfg: SDESampleConfig = SDESampleConfig(),
                 args=None, noise_shape=None, clock=None, device=None):
        self._eng = SDESampleEngine(term, y0, cfg, args=args,
                                    noise_shape=noise_shape, clock=clock,
                                    device=device)
        self.cfg = self._eng.cfg
        self.scheduler = self._eng.scheduler
        self.executor = self._eng.executor
        self._task: Optional[asyncio.Task] = None
        self._work = asyncio.Event()    # set: queue may hold plannable work
        self._space = asyncio.Event()   # set: admission capacity may exist
        self._waiters: Dict[int, asyncio.Future] = {}
        self._last_group = None
        self._closed = False
        # Retired-but-not-finalized request ids, in retirement order.  An
        # attribute, not serve-loop state, so a supervised restart still
        # finalizes (and retries) what the crashed loop had delivered.
        self._pending_fin: List[int] = []
        # By retired request id: the event recorded after its results were
        # stacked, and (on CUDA) a host copy of its divergence flags made
        # before it, so finalization reads them without waiting on the
        # dispatches enqueued since.
        self._stacked: Dict[int, torch.cuda.Event] = {}
        self._host_flags: Dict[int, torch.Tensor] = {}

    # -- client surface ------------------------------------------------------

    @property
    def done(self) -> Dict[int, SampleResult]:
        """Completed results (device tensors) by request id."""
        return self.scheduler.done

    def pending(self, detail: bool = False):
        return self._eng.pending(detail=detail)

    def warmup(self, signatures) -> int:
        """Prepare expected traffic — see :meth:`SDESampleEngine.warmup`
        (synchronous: call before serving, or wrap in ``asyncio.to_thread``
        from a live loop)."""
        return self._eng.warmup(signatures)

    async def submit(self, solver: str, *, t1: float, n_steps: int,
                     n_paths: int, t0: float = 0.0,
                     save_every: Optional[int] = None,
                     seed: Optional[int] = None,
                     rtol: Optional[float] = None,
                     atol: Optional[float] = None, save_at=None,
                     priority: int = 0,
                     deadline_ms: Optional[float] = None) -> int:
        """Queue a sampling request; returns its request id.

        Same options and validation as the sync engine's ``submit``, but a
        full bounded queue makes this coroutine wait for space: it raises
        only for malformed requests, never :class:`QueueFull`.  A request
        whose ``deadline_ms`` elapses before delivery wakes its
        :meth:`result` waiter with ``TimeoutError``."""
        if self._closed:
            raise RuntimeError("engine is closed")
        self._ensure_serving()
        while True:
            try:
                # Validation errors propagate at once; only QueueFull waits.
                rid = self._eng.submit(
                    solver, t1=t1, n_steps=n_steps, n_paths=n_paths, t0=t0,
                    save_every=save_every, seed=seed, rtol=rtol, atol=atol,
                    save_at=save_at, priority=priority,
                    deadline_ms=deadline_ms,
                )
                break
            except QueueFull:
                # Capacity appears only through the serve task or cancel(),
                # which set the event after this clear: no lost wakeup.
                self._space.clear()
                await self._space.wait()
        self._work.set()
        return rid

    def _unfinalized(self, request_id: int) -> bool:
        """Whether ``request_id`` (a root id) has a retirement, its own or a
        retry child's, still awaiting finalization: its result in ``done``
        is then provisional (finalization may turn it into a retry)."""
        return any(self._eng._retry_parent.get(c, c) == request_id
                   for c in self._pending_fin)

    async def result(self, request_id: int, *, numpy: bool = False
                     ) -> SampleResult:
        """Await a request's :class:`SampleResult`.

        Returns device tensors once every path is integrated (the await
        covers device completion, not just retirement) and the engine
        finalized the request (its divergence flags read, any retry ladder
        run); ``numpy=True`` copies them to the host off-thread.  Raises
        ``asyncio.CancelledError`` for a cancelled request, ``TimeoutError``
        when its deadline expired before delivery, ``KeyError`` for ids this
        engine never handed out."""
        res = self.done.get(request_id)
        if res is not None and self._unfinalized(request_id):
            res = None  # provisional: the engine may still retry it
        if res is None:
            if request_id in self.scheduler._cancelled_ids:
                raise asyncio.CancelledError(
                    f"request {request_id} was cancelled")
            queued = any(p.request.request_id == request_id
                         for p in self.scheduler.queue)
            # A root mid-retry is absent from the queue (its degraded child
            # rides there under a negative internal id).
            if not (queued or request_id in self._eng._retry_attempt
                    or self._unfinalized(request_id)):
                raise KeyError(f"unknown request id {request_id}")
            self._ensure_serving()
            fut = self._waiters.get(request_id)
            if fut is None:
                fut = asyncio.get_running_loop().create_future()
                self._waiters[request_id] = fut
            res = await asyncio.shield(fut)
        if res.timed_out:
            raise TimeoutError(
                f"request {request_id} deadline expired before delivery")
        # Wait for the device off-thread, so submitters and the serve loop
        # keep running meanwhile.
        await _landed(self._stacked.get(request_id))
        if numpy:
            res = await asyncio.to_thread(self._to_numpy, res)
        return res

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued request (see the sync engine's ``cancel``); a
        coroutine awaiting its result receives ``CancelledError``, and one
        blocked ``submit`` may be admitted into the freed capacity."""
        cancelled = self._eng.cancel(request_id)
        if cancelled:
            fut = self._waiters.pop(request_id, None)
            if fut is not None and not fut.done():
                fut.cancel(f"request {request_id} was cancelled")
            self._space.set()
        return cancelled

    async def drain(self) -> Dict[Any, Any]:
        """Await every currently queued request; returns a snapshot of
        ``done`` plus a ``"counters"`` entry (the engine-lifetime retries,
        timeouts, divergences and restarts).  Requests cancelled or timed
        out mid-drain are skipped (both are terminal)."""
        roots = {self._eng._retry_parent.get(r, r) for r in self.pending()}
        for rid in sorted(roots):
            try:
                await self.result(rid)
            except (asyncio.CancelledError, TimeoutError):
                pass  # terminal either way; nothing owed
        out: Dict[Any, Any] = dict(self.done)
        out["counters"] = dict(self._eng.counters)
        return out

    async def close(self) -> None:
        """Stop the serve task.  Queued-but-unserved requests are abandoned
        (their ``result`` awaiters receive ``CancelledError``; ``drain``
        first for a graceful shutdown); completed results stay in ``done``."""
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception:
                # The serve loop already crashed and handed its exception to
                # every waiter: tearing the engine down does not raise it
                # a second time.
                pass
            self._task = None
        for fut in self._waiters.values():
            if not fut.done():
                fut.cancel("engine closed")
        self._waiters.clear()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    # -- serve loop ----------------------------------------------------------

    def _ensure_serving(self) -> None:
        if self._task is not None and self._task.done():
            # Surface a crashed serve loop to the caller instead of hanging.
            exc = self._task.exception()
            self._task = None
            if exc is not None:
                raise exc
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._serve(), name="sde-serve-loop")

    def _next_plan(self):
        """Round-robin stacks across the planning groups of the best pending
        priority class (groups are buckets where coalescing applies)."""
        groups = self.scheduler.groups()
        if not groups:
            return None
        best = max(prio for _, prio in groups)
        top = [g for g, prio in groups if prio == best]
        if self._last_group in top and len(top) > 1:
            g = top[(top.index(self._last_group) + 1) % len(top)]
        else:
            g = top[0]
        self._last_group = g
        return self.scheduler.plan(self.cfg.slots,
                                   self.cfg.ticks_per_dispatch,
                                   group=g)

    def _deliver_device(self, plan, result) -> List[int]:
        """Scatter a dispatch lazily: slot views and per-request
        ``torch.stack``s on the executor's stream, so delivery never waits
        on (or copies to) the host, except for each retiree's divergence
        flags, copied to pinned host memory without blocking.  Retirement
        frees admission capacity at once; *finalization* waits for the next
        landing (:meth:`_finalize`)."""
        outputs = {"y_final": result.y_final, "ys": result.ys}
        for name in STAT_FIELDS:
            outputs[name] = getattr(result, name, None)
        with self.executor.on_stream():
            retired = self.scheduler.deliver(plan, outputs, stack=torch.stack)
            for rid in retired:
                flags = self.done[rid].diverged
                if self.executor.stream is not None and flags is not None:
                    host = torch.empty(flags.shape, dtype=flags.dtype,
                                       pin_memory=True)
                    self._host_flags[rid] = host.copy_(flags, non_blocking=True)
        event = self.executor.record_landing()
        for rid in retired:
            self._eng._key_cache.pop(rid, None)
            if event is not None:
                self._stacked[rid] = event
        self._pending_fin.extend(retired)
        if retired:
            self._space.set()
        return retired

    async def _finalize(self, n: int) -> None:
        """Finalize the first ``n`` retirements awaiting it: wait (off-thread)
        until their results and divergence flags landed, let the engine book
        divergence and run the retry ladder, and wake ``result`` waiters.

        The wait happens while the ids are still in ``_pending_fin``, so a
        concurrent ``result()`` keeps seeing them as provisional; everything
        after it is await-free, so removal, retry enqueueing and waiter
        wakeup are atomic with respect to the loop."""
        if not n:
            return
        rids = self._pending_fin[:n]
        events = {id(e): e for e in map(self._stacked.get, rids) if e is not None}
        for event in events.values():
            await _landed(event)
        del self._pending_fin[:n]
        retried = False
        for rid in rids:
            event = self._stacked.pop(rid, None)
            root = self._eng._finalize_retired(rid, self._host_flags.pop(rid, None))
            if root is None:
                retried = True  # back on the queue, degraded
                continue
            if event is not None:
                self._stacked[root] = event
            fut = self._waiters.pop(root, None)
            if fut is not None and not fut.done():
                fut.set_result(self.done[root])
        if retried:
            self._work.set()

    def _expire_wake(self) -> None:
        """Retire deadline-expired requests and wake their waiters with
        ``TimeoutError``; expiry frees admission capacity."""
        expired = self._eng._expire()
        for root in expired:
            fut = self._waiters.pop(root, None)
            if fut is not None and not fut.done():
                fut.set_exception(TimeoutError(
                    f"request {root} deadline expired before delivery"))
        if expired:
            self._space.set()

    async def _serve(self) -> None:
        while True:
            try:
                await self._serve_loop()
                return
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                transient = getattr(exc, "transient", False)
                if (transient and self._eng.counters["restarts"]
                        < self.cfg.max_restarts):
                    # Supervised restart: plans are unreserved and delivery
                    # is atomic per subplan, so the replan serves exactly
                    # the undelivered ticks; _pending_fin survives.
                    self._eng.counters["restarts"] += 1
                    continue
                # Fail awaiters loudly, never hang them.
                for fut in self._waiters.values():
                    if not fut.done():
                        fut.set_exception(exc)
                self._waiters.clear()
                raise

    async def _serve_loop(self) -> None:
        inflight = None  # the previous dispatch's landing event
        while True:
            self._expire_wake()
            plan = self._next_plan()
            if plan is None:
                if inflight is not None or self._pending_fin:
                    if inflight is not None:
                        await _landed(inflight)
                        inflight = None
                    await self._finalize(len(self._pending_fin))
                    # A submit may have landed during the awaits, and a
                    # finalized retry is plannable work: loop, don't sleep.
                    continue
                self._work.clear()
                if self.scheduler.signatures():
                    continue  # raced with clear(): serve it, don't sleep
                await self._work.wait()
                continue
            with self.executor.on_stream():
                keys = self._eng._plan_keys(plan)
            offset = 0
            subplans = self._eng._split_subplans(plan)
            for sp in subplans:
                sp_keys = keys if len(subplans) == 1 else \
                    keys[offset:offset + sp.n_ticks]
                offset += sp.n_ticks
                ek = self._eng._exec_key(sp)
                active = self._eng._active_steps(sp)
                if self.executor.has_compiled(ek, sp.n_ticks, active):
                    out = self.executor.dispatch(ek, sp_keys, active)
                else:
                    # A first dispatch may build kernel libraries and capture
                    # tick graphs: run it off-thread so submit()/result()
                    # stay live meanwhile.
                    out = await asyncio.to_thread(
                        self.executor.dispatch, ek, sp_keys, active)
                landing = self.executor.landing
                # Only retirements from dispatches before this one become
                # finalizable once the previous stack lands.
                n_ready = len(self._pending_fin)
                self._deliver_device(sp, out)
                if inflight is not None:
                    # Double buffering to depth 2: the previous stack lands
                    # before a third enters flight.
                    await _landed(inflight)
                await self._finalize(n_ready)
                inflight = landing
            # Let submitters and cancellers in between stacks.
            await asyncio.sleep(0)

    @staticmethod
    def _to_numpy(res: SampleResult) -> SampleResult:
        conv = lambda x: None if x is None else x.cpu().numpy()  # noqa: E731
        return dataclasses.replace(
            res, y_final=conv(res.y_final), ys=conv(res.ys),
            **{n: conv(getattr(res, n)) for n in STAT_FIELDS},
        )
