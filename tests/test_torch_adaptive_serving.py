"""Adaptive requests through the port's sync and async engines.

Within the port, bitwise: an adaptive request's ``y_final``, ``ys``,
``t_final``, ``n_accepted`` and ``n_rejected`` equal an offline
``sdeint(..., bounded=False)`` over the request's path keys
(``fold_in(PRNGKey(seed), i)``), across ticks, ``ticks_per_dispatch`` and
both engines.  Options are validated at submit, as in the reference's
``TestEngineAdaptive``.  The three adaptive benchmarks run small on the CPU
and refuse ``BENCH_*.json`` names.
"""
import asyncio

import numpy as np
import pytest
import torch

from repro_torch.core import PRNGKey, SDETerm, path_keys, sdeint
from repro_torch.serving import AsyncSDESampleEngine, SDESampleConfig, SDESampleEngine


def term():
    return SDETerm(drift=lambda t, y, a: -0.5 * y,
                   diffusion=lambda t, y, a: 0.2 * (1.0 + 0.1 * torch.tanh(y)),
                   noise="diagonal")


ADAPTIVE = dict(t1=1.0, n_steps=128, n_paths=6, rtol=1e-3, save_at=[0.5, 1.0],
                seed=11)


def offline(n_paths=6, seed=11, spec="ees25:adaptive"):
    keys = path_keys(PRNGKey(seed, device="cpu"), n_paths)
    with torch.no_grad():
        return sdeint(term(), spec, 0.0, 1.0, 128, torch.ones(3), None,
                      rtol=1e-3, save_at=[0.5, 1.0], batch_keys=keys,
                      bounded=False, device="cpu")


def assert_matches(res, ref):
    np.testing.assert_array_equal(res.y_final, ref.y_final.numpy())
    np.testing.assert_array_equal(res.ys, ref.ys.numpy())
    np.testing.assert_array_equal(res.t_final, ref.t_final.numpy())
    np.testing.assert_array_equal(res.n_accepted, ref.n_accepted.numpy())
    np.testing.assert_array_equal(res.n_rejected, ref.n_rejected.numpy())


@pytest.mark.parametrize("slots,tpd", [(4, 1), (4, 2), (8, 1)])
def test_sync_engine_equals_offline_sdeint(slots, tpd):
    eng = SDESampleEngine(term(), torch.ones(3),
                          SDESampleConfig(slots=slots, ticks_per_dispatch=tpd),
                          device="cpu")
    rid = eng.submit("ees25:adaptive", **ADAPTIVE)
    fixed = eng.submit("ees25", t1=1.0, n_steps=8, n_paths=5, seed=3)
    done = eng.run()
    res = done[rid]
    assert res.y_final.shape == (6, 3) and res.ys.shape == (6, 2, 3)
    assert res.t_final.shape == res.n_accepted.shape == res.n_rejected.shape == (6,)
    np.testing.assert_array_equal(res.t_final, 1.0)
    assert (res.n_accepted >= 1).all() and not res.diverged.any()
    assert_matches(res, offline())
    assert done[fixed].t_final is None and done[fixed].n_accepted is None


def test_async_engine_equals_sync_drain():
    async def serve():
        cfg = SDESampleConfig(slots=4, ticks_per_dispatch=2)
        async with AsyncSDESampleEngine(term(), torch.ones(3), cfg,
                                        device="cpu") as eng:
            a = await eng.submit("ees25:adaptive", **ADAPTIVE)
            b = await eng.submit("ees27:adaptive", t1=1.0, n_steps=128,
                                 n_paths=3, rtol=1e-3, save_at=[0.5, 1.0],
                                 seed=5)
            return (await eng.result(a, numpy=True),
                    await eng.result(b, numpy=True))

    ra, rb = asyncio.run(asyncio.wait_for(serve(), 300))
    assert_matches(ra, offline())
    assert_matches(rb, offline(3, 5, "ees27:adaptive"))


def test_adaptive_options_validated_at_submit():
    eng = SDESampleEngine(term(), torch.ones(3), device="cpu")
    with pytest.raises(ValueError, match="adaptive"):
        eng.submit("ees25", t1=1.0, n_steps=8, n_paths=1, rtol=1e-3)
    with pytest.raises(ValueError, match="adaptive"):
        eng.submit("ees25", t1=1.0, n_steps=8, n_paths=1, save_at=[0.5])
    with pytest.raises(ValueError, match="save_at"):
        eng.submit("ees25:adaptive", t1=1.0, n_steps=8, n_paths=1, save_every=4)
    with pytest.raises(ValueError, match="save_at"):
        eng.submit("ees25:adaptive", t1=1.0, n_steps=8, n_paths=1,
                   save_at=[2.5])  # outside [t0, t1]
    assert not eng.queue
    assert eng.submit("ees25:adaptive", t1=1.0, n_steps=8, n_paths=1) == 0


def test_adaptive_requests_are_never_bucketed():
    eng = SDESampleEngine(term(), torch.ones(3), SDESampleConfig(slots=4),
                          device="cpu")
    rid = eng.submit("ees25:adaptive", t1=1.0, n_steps=64, n_paths=2, seed=1)
    res = eng.run()[rid]
    assert res.bucket is None


def test_bench_load_serves_the_adaptive_mix_on_the_cpu(tmp_path):
    """bench_load's population includes an adaptive signature; a small run
    reports finite latencies and the bucketing section's counts."""
    import json

    from repro_torch.benchmarks import bench_load

    out = tmp_path / "load.json"
    bench_load.main(["--device", "cpu", "--requests", "6", "--rate", "200",
                     "--slots", "4", "--out", str(out)])
    payload = json.loads(out.read_text())
    load, buckets = payload["load"], payload["bucketing"]
    assert "ees25/adaptive" in {s["name"] for s in bench_load.POPULATION}
    assert np.isfinite([load["p50_ms"], load["p99_ms"], load["saturation_rps"]]).all()
    assert load["dispatches_per_tick"] <= 1
    assert buckets["n_executables_bucketed"] <= buckets["n_buckets"] \
        < buckets["n_signatures"]


@pytest.mark.parametrize("module", ["bench_load", "bench_adaptive",
                                    "bench_reversible_adaptive"])
def test_adaptive_benchmarks_refuse_a_bench_name(module):
    import importlib

    mod = importlib.import_module(f"repro_torch.benchmarks.{module}")
    with pytest.raises(SystemExit, match="BENCH_"):
        mod.main(["--device", "cpu", "--out", "BENCH_adaptive.json"])


def test_bench_adaptive_runs_small_on_the_cpu():
    from repro_torch.benchmarks import bench_adaptive

    payload = bench_adaptive.run(device="cpu", n_paths=4, rtols=(1e-2,),
                                 fixed_steps=(8, 16), ref_steps=256)
    (rec,) = payload["records"]["adaptive"]
    assert rec["mean_accepted"] >= 1 and np.isfinite(rec["strong_err"])
    assert np.isfinite(rec["steps_saved_ratio"])
