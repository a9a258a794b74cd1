"""The port's fault injection (``repro_torch.serving.faults``) against the
reference's, and the robustness layer under it.

Mirrors ``tests/test_faults.py`` class for class: NaN isolation, the retry
ladder, crash recovery (sync and async), deadlines on a ``FakeClock`` and
seeded fault sweeps.  Each scenario runs in both packages on the same
requests and seeds, in float64: the port's injector must fire the same
faults (``n_dispatch_calls``, ``n_crashes``, ``n_nans``, ``n_delays``) and
end with the same engine counters as the reference's, with samples within
1e-10 relative (the float64 normals differ by erfinv ulps); within the port,
whatever no fault touched is bitwise the fault-free run.
"""
import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serving as jserving
import repro_torch.core as tcore
import repro_torch.serving as tserving
from repro_torch.serving import (AsyncSDESampleEngine, FakeClock, FaultConfig,
                                 InjectedCrash, RetryPolicy, SDESampleConfig,
                                 SDESampleEngine, inject_faults)


def run_bounded(coro, seconds=300):
    """``asyncio.run`` with a time bound: a hung serve loop fails the test."""
    return asyncio.run(asyncio.wait_for(coro, seconds))


LIBS = {"jax": (jcore, jserving, jnp), "torch": (tcore, tserving, torch)}
FIRED = ("n_dispatch_calls", "n_crashes", "n_nans", "n_delays")


def term(lib="torch"):
    core, _, xp = LIBS[lib]
    return core.SDETerm(drift=lambda t, y, a: -0.5 * y,
                        diffusion=lambda t, y, a: 0.2 * xp.ones_like(y),
                        noise="diagonal")


def stiff_term(lib="torch"):
    # Blows up on the coarse grids below; stable once the ladder halves h.
    core, _, xp = LIBS[lib]
    return core.SDETerm(drift=lambda t, y, a: -40.0 * y,
                        diffusion=lambda t, y, a: 0.05 * xp.ones_like(y),
                        noise="diagonal")


def y0(lib="torch"):
    return (jnp.ones(3, jnp.float64) if lib == "jax"
            else torch.ones(3, dtype=torch.float64))


def engine(lib="torch", t=None, *, slots=4, clock=None, asynchronous=False,
           **cfg_kw):
    _, serving, _ = LIBS[lib]
    dtype = jnp.float64 if lib == "jax" else torch.float64
    cfg = serving.SDESampleConfig(slots=slots, dtype=dtype, **cfg_kw)
    cls = serving.AsyncSDESampleEngine if asynchronous else serving.SDESampleEngine
    kw = {} if lib == "jax" else {"device": "cpu"}
    return cls(t if t is not None else term(lib), y0(lib), cfg, clock=clock, **kw)


def host(x):
    return None if x is None else np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def assert_close(got, want):
    g, w = host(got), host(want)
    scale = max(1.0, np.abs(w).max())
    assert np.abs(g - w).max() / scale < 1e-10


def fired(inj):
    return {n: getattr(inj, n) for n in FIRED}


def serve_sync(lib, fault_cfg, requests, t=None, slots=4, **cfg_kw):
    """Submit ``requests`` (submit kwargs) to a sync engine, optionally under
    ``fault_cfg``, drain; returns (results in submit order, engine counters,
    injector counters or None)."""
    eng = engine(lib, t, slots=slots, **cfg_kw)
    _, serving, _ = LIBS[lib]
    inj = (serving.inject_faults(eng, serving.FaultConfig(**fault_cfg))
           if fault_cfg is not None else None)
    rids = [eng.submit("ees25", **r) for r in requests]
    done = eng.run()
    return ([done[r] for r in rids], dict(eng.counters),
            fired(inj) if inj is not None else None)


def serve_async(lib, fault_cfg, requests, t=None, slots=4, **cfg_kw):
    """The async counterpart of :func:`serve_sync` (results awaited in
    submit order, then a drain)."""
    _, serving, _ = LIBS[lib]

    async def go():
        async with engine(lib, t, slots=slots, asynchronous=True, **cfg_kw) as eng:
            inj = (serving.inject_faults(eng, serving.FaultConfig(**fault_cfg))
                   if fault_cfg is not None else None)
            rids = [await eng.submit("ees25", **r) for r in requests]
            results = [await eng.result(r) for r in rids]
            out = await eng.drain()
            return (results, out["counters"],
                    fired(inj) if inj is not None else None)

    return run_bounded(go())


def assert_same_as_reference(serve, fault_cfg, requests, t=None, **kw):
    """The scenario in both packages: equal fired faults, counters and
    retries; samples within 1e-10."""
    got = serve("torch", fault_cfg, requests,
                None if t is None else t("torch"), **kw)
    want = serve("jax", fault_cfg, requests, None if t is None else t("jax"), **kw)
    assert got[2] == want[2]
    assert got[1] == want[1]
    for g, w in zip(got[0], want[0]):
        assert (g.retries, g.timed_out) == (w.retries, w.timed_out)
        if w.y_final is not None:
            assert_close(g.y_final, w.y_final)
            assert np.array_equal(host(g.diverged), host(w.diverged))
    return got


TWO = [dict(t1=1.0, n_steps=16, n_paths=2, seed=1),
       dict(t1=1.0, n_steps=16, n_paths=2, seed=2)]


class TestNaNIsolation:
    def test_victim_retries_cobatched_request_bitwise_clean(self):
        # Two 2-path requests share one 4-slot tick; slot 0 of dispatch 0
        # (the victim's) is corrupted.
        (a, b), counters, inj = serve_sync("torch", dict(nan_slots=((0, 0, 0),)), TWO)
        (ra, rb), _, _ = serve_sync("torch", None, TWO)
        assert inj["n_nans"] == 1
        assert np.array_equal(b.y_final, rb.y_final) and b.retries == 0
        assert a.retries == 1 and np.isfinite(a.y_final).all()
        assert (counters["retries"], counters["diverged_requests"],
                counters["diverged_paths"]) == (1, 1, 1)

    def test_matches_reference(self):
        assert_same_as_reference(serve_sync, dict(nan_slots=((0, 0, 0),)), TWO)

    def test_counters_surface_via_pending_detail(self):
        eng = engine()
        inject_faults(eng, FaultConfig(nan_slots=((0, 0, 0),)))
        eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4, seed=1)
        eng.run()
        detail = eng.pending(detail=True)["counters"]
        assert (detail["retries"], detail["diverged_requests"],
                detail["timeouts"]) == (1, 1, 0)

    def test_corruption_is_on_a_copy(self):
        """The injector NaNs a copy: the executor's own output is intact."""
        eng = engine()
        clean = eng.executor
        seen = []
        real = clean.dispatch

        def spy(*a, **kw):
            out = real(*a, **kw)
            seen.append(out)
            return out

        clean.dispatch = spy
        inject_faults(eng, FaultConfig(nan_slots=((0, 0, 0),)))
        eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4, seed=1)
        eng.run()
        assert torch.isfinite(seen[0].y_final).all()
        assert not seen[0].diverged.any()


class TestRetryLadder:
    def test_stiff_request_walks_ladder_like_the_reference(self):
        (res,), counters, _ = assert_same_as_reference(
            serve_sync, None, [dict(t1=1.0, n_steps=8, n_paths=4, seed=0)],
            t=stiff_term)
        assert res.retries >= 1 and np.isfinite(res.y_final).all()
        assert counters["retries"] == res.retries
        assert counters["diverged_requests"] >= 1

    def test_retries_capped_result_surfaces_diverged(self):
        pol_kw = dict(retry_policy=RetryPolicy(max_retries=1, max_h_halvings=0))
        (res,), _, _ = serve_sync(
            "torch", None, [dict(t1=1.0, n_steps=4, n_paths=4, seed=0)],
            t=stiff_term("torch"), **pol_kw)
        assert res.retries == 1 and res.diverged.any()
        want, _, _ = serve_sync(
            "jax", None, [dict(t1=1.0, n_steps=4, n_paths=4, seed=0)],
            t=stiff_term("jax"),
            retry_policy=jserving.RetryPolicy(max_retries=1, max_h_halvings=0))
        assert np.array_equal(res.diverged, np.asarray(want[0].diverged))

    def test_async_retry_lands_under_root_id(self):
        (res,), counters, _ = assert_same_as_reference(
            serve_async, None, [dict(t1=1.0, n_steps=8, n_paths=4, seed=0)],
            t=stiff_term)
        assert res.retries >= 1 and torch.isfinite(res.y_final).all()
        assert counters["retries"] == res.retries


FOUR = [dict(t1=1.0, n_steps=16, n_paths=4, seed=i) for i in range(4)]


class TestCrashRecovery:
    def test_sync_crash_releases_reservations_rerun_bitwise(self):
        ref, _, _ = serve_sync("torch", None, FOUR)
        eng = engine()
        inj = inject_faults(eng, FaultConfig(crash_dispatches=(1,)))
        rids = [eng.submit("ees25", **r) for r in FOUR]
        with pytest.raises(InjectedCrash):
            eng.run()
        assert inj.n_crashes == 1
        done = eng.run()  # the crashed work went back on the queue
        assert set(done) == set(rids)
        for rid, r in zip(rids, ref):
            assert np.array_equal(done[rid].y_final, r.y_final)

    def test_async_supervised_restart_serves_all_bitwise(self):
        ref, _, _ = serve_async("torch", None, FOUR)
        got, counters, inj = assert_same_as_reference(
            serve_async, dict(crash_dispatches=(0,)), FOUR)
        assert inj["n_crashes"] == 1 and counters["restarts"] == 1
        for g, r in zip(got, ref):
            assert torch.equal(g.y_final, r.y_final)

    def test_async_restart_budget_exhausted_fails_waiters(self):
        async def go():
            async with engine(asynchronous=True, max_restarts=1) as eng:
                inject_faults(eng, FaultConfig(crash_rate=1.0))
                rid = await eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4,
                                       seed=0)
                with pytest.raises(InjectedCrash):
                    await eng.result(rid)
                assert eng._eng.counters["restarts"] == 1

        run_bounded(go())

    def test_non_transient_error_is_not_restarted(self):
        class Boom(RuntimeError):
            pass

        async def go():
            async with engine(asynchronous=True) as eng:
                def bad(*a, **kw):
                    raise Boom("hard failure")

                eng._eng.executor.dispatch = bad
                rid = await eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4,
                                       seed=0)
                with pytest.raises(Boom):
                    await eng.result(rid)
                assert eng._eng.counters["restarts"] == 0

        run_bounded(go())


class TestDeadlines:
    def test_sync_deadline_times_out_in_queue(self):
        clk = FakeClock()
        eng = engine(clock=clk)
        rid = eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4, seed=0,
                         deadline_ms=50.0)
        clk.advance(0.2)
        res = eng.run()[rid]
        assert res.timed_out and res.y_final is None
        assert eng.counters["timeouts"] == 1

    def test_sync_deadline_not_hit_serves_normally(self):
        clk = FakeClock()
        eng = engine(clock=clk)
        rid = eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4, seed=0,
                         deadline_ms=1e6)
        res = eng.run()[rid]
        assert not res.timed_out and np.isfinite(res.y_final).all()
        assert eng.counters["timeouts"] == 0

    def test_deadline_remaining_visible_in_pending_detail(self):
        clk = FakeClock()
        eng = engine(clock=clk)
        rid = eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4, seed=0,
                         deadline_ms=1000.0)
        assert eng.pending(detail=True)[rid]["deadline_remaining_s"] == \
            pytest.approx(1.0)

    def test_fake_clock_equals_reference(self):
        for cls in (FakeClock, jserving.FakeClock):
            clk = cls(2.0)
            clk.advance(0.5)
            assert clk() == 2.5

    def test_async_deadline_raises_and_frees_capacity(self):
        async def go():
            clk = FakeClock()
            async with engine(asynchronous=True, clock=clk) as eng:
                rid = await eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4,
                                       seed=0, deadline_ms=1.0)
                clk.advance(10.0)
                with pytest.raises(TimeoutError):
                    await eng.result(rid)
                assert eng._eng.counters["timeouts"] == 1
                rid2 = await eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4,
                                        seed=7)
                return await eng.result(rid2, numpy=True)

        res = run_bounded(go())
        (ref,), _, _ = serve_sync("torch", None,
                                  [dict(t1=1.0, n_steps=16, n_paths=4, seed=7)])
        assert np.array_equal(res.y_final, ref.y_final)


class TestRandomizedFaultSweeps:
    """Seeded fault schedules in both packages: the same faults fire, the
    engines end with the same counters, every request retires exactly once,
    and what the schedule did not touch is bitwise the fault-free run."""

    N_REQ = 6
    MIX = [dict(t1=1.0 + (i % 2), n_steps=16, n_paths=2, seed=i)
           for i in range(N_REQ)]

    @pytest.mark.parametrize("seed", range(4))
    def test_sync_nan_schedule(self, seed):
        clean, _, _ = serve_sync("torch", None, self.MIX)
        got, counters, inj = assert_same_as_reference(
            serve_sync, dict(seed=seed, nan_rate=0.4), self.MIX)
        assert len(got) == self.N_REQ
        for res, ref in zip(got, clean):
            assert np.isfinite(res.y_final).all()
            if res.retries == 0:
                assert np.array_equal(res.y_final, ref.y_final)
        assert counters["retries"] >= (1 if inj["n_nans"] else 0)

    @pytest.mark.parametrize("seed", range(4))
    def test_async_crash_and_nan_interleaving(self, seed):
        clean, _, _ = serve_sync("torch", None, self.MIX)
        got, counters, inj = assert_same_as_reference(
            serve_async, dict(seed=seed, nan_rate=0.3, crash_rate=0.2),
            self.MIX, max_restarts=100)
        assert counters["restarts"] == inj["n_crashes"]
        for res, ref in zip(got, clean):
            assert torch.isfinite(res.y_final).all()
            if res.retries == 0:
                assert np.array_equal(host(res.y_final), ref.y_final)

    def test_faulty_executor_delegates_and_counts(self):
        eng = engine()
        inj = inject_faults(eng, FaultConfig(seed=0, delay_rate=1.0,
                                             delay_s=0.001))
        eng.submit("ees25", t1=1.0, n_steps=16, n_paths=4, seed=0)
        eng.run()
        assert inj.n_delays >= 1 and inj.n_dispatch_calls >= 1
        assert inj.n_crashes == 0 and inj.n_nans == 0
        assert inj.n_dispatches == eng.executor.inner.n_dispatches
        assert inj.has_compiled is not None and inj.stream is None  # the CPU's

    def test_delay_schedule_matches_reference(self):
        assert_same_as_reference(
            serve_sync, dict(seed=3, delay_rate=0.5, delay_s=0.001,
                             nan_rate=0.2), self.MIX)
