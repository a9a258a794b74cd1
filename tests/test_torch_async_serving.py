"""The port's async serving plane, warmup and persistent kernel cache against
the reference's and against the port's own sync engine.

Within the port the async drain equals the sync drain bitwise, across
``ticks_per_dispatch``, priorities and bucketing.  Against the reference, the
same requests and seeds give the same samples: float64 here (1e-10 relative:
the float64 normals differ by erfinv ulps), float32 in a subprocess without
x64 (1e-4 of the largest sample).  Results stay device tensors until
``numpy=True``.  ``warmup`` counts what the reference's counts;
``spec_kernels`` names exactly the kernel wrappers a solve calls.
"""
import asyncio
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nsde import init_lsde as jinit, lsde_term as jterm
from repro.serving import AsyncSDESampleEngine as JAsync
from repro.serving.sde_engine import SDESampleConfig as JConfig, SDESampleEngine as JEngine
from repro_torch.core import PRNGKey, SDETerm, path_keys
from repro_torch.kernels import _build
from repro_torch.kernels.sde_step import ops as sde_ops
from repro_torch.kernels.williamson2n import ops as w2n_ops
from repro_torch.nsde import lsde_params_from_jax, lsde_term
from repro_torch.serving import (AsyncSDESampleEngine, BucketKey, SDESampleConfig,
                                 SDESampleEngine, TickExecutor)
from repro_torch.serving.executor import spec_kernels


def run_bounded(coro, seconds=300):
    """``asyncio.run`` with a time bound: a hung serve loop fails the test."""
    return asyncio.run(asyncio.wait_for(coro, seconds))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_Z, WIDTH = 4, 8

REQUESTS = [  # (solver, t1, n_steps, n_paths, save_every, seed)
    ("ees25:use_kernels=True", 2.0, 8, 20, None, 1),   # bucket (h=0.25, 8)
    ("ees25:use_kernels=True", 1.5, 6, 8, None, 2),    # same bucket
    ("ees27", 2.0, 16, 8, 4, 3),                       # exact (saves)
    ("ees25", 1.0, 4, 5, None, 4),                     # bucket (h=0.25, 8)
]


@pytest.fixture(scope="module")
def lsde64():
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64), jinit(jax.random.PRNGKey(1), 1, D_Z, WIDTH))
    y0 = jnp.linspace(-0.5, 0.5, D_Z)
    return params, y0, lsde_params_from_jax(params, device="cpu"), torch.from_numpy(np.array(y0))


def _cfg(**kw):
    return SDESampleConfig(**dict(dict(slots=8, ticks_per_dispatch=2,
                                       dtype=torch.float64), **kw))


def _sync(tparams, ty0, prios=(0, 0, 0, 0), **kw):
    eng = SDESampleEngine(lsde_term(), ty0, _cfg(**kw), args=tparams, device="cpu")
    rids = [eng.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se, seed=seed,
                       priority=pr)
            for (s, t1, n, p, se, seed), pr in zip(REQUESTS, prios)]
    done = eng.run()
    return [done[r] for r in rids]


def _async(tparams, ty0, prios=(0, 0, 0, 0), numpy=True, **kw):
    async def main():
        async with AsyncSDESampleEngine(lsde_term(), ty0, _cfg(**kw), args=tparams,
                                        device="cpu") as eng:
            rids = [await eng.submit(s, t1=t1, n_steps=n, n_paths=p,
                                     save_every=se, seed=seed, priority=pr)
                    for (s, t1, n, p, se, seed), pr in zip(REQUESTS, prios)]
            return [await eng.result(r, numpy=numpy) for r in rids]
    return run_bounded(main())


@pytest.mark.parametrize("ticks_per_dispatch", [1, 4])
@pytest.mark.parametrize("prios", [(0, 0, 0, 0), (0, 5, 1, 2)])
def test_async_bitwise_equals_sync_drain(lsde64, ticks_per_dispatch, prios):
    _, _, tparams, ty0 = lsde64
    want = _sync(tparams, ty0, prios, ticks_per_dispatch=ticks_per_dispatch)
    got = _async(tparams, ty0, prios, ticks_per_dispatch=ticks_per_dispatch)
    for g, w in zip(got, want):
        assert np.array_equal(g.y_final, w.y_final)
        assert (g.ys is None) == (w.ys is None)
        if w.ys is not None:
            assert np.array_equal(g.ys, w.ys)
        assert np.array_equal(g.diverged, w.diverged)


@pytest.mark.parametrize("variant", [dict(bucketing=False), dict(double_buffer=False),
                                     dict(guard_threshold=None)])
def test_async_bucketed_bitwise_equals_sync(lsde64, variant):
    """The bucketed async drain equals the sync one and the exact one."""
    _, _, tparams, ty0 = lsde64
    got = _async(tparams, ty0)
    assert isinstance(got[0].bucket, BucketKey) and got[0].bucket == got[1].bucket
    assert got[1].n_padded_steps == 2 and got[2].bucket is None
    for g, w in zip(got, _sync(tparams, ty0, **variant)):
        assert np.array_equal(g.y_final, w.y_final)


def test_async_equals_reference_float64(lsde64):
    params, y0, tparams, ty0 = lsde64

    async def ref():
        async with JAsync(jterm(), y0, JConfig(slots=8, ticks_per_dispatch=2,
                                               dtype=jnp.float64), args=params) as eng:
            rids = [await eng.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se,
                                     seed=seed)
                    for s, t1, n, p, se, seed in REQUESTS]
            return [await eng.result(r, numpy=True) for r in rids]

    for g, w in zip(_async(tparams, ty0), run_bounded(ref())):
        scale = max(1.0, np.abs(w.y_final).max())
        assert np.abs(g.y_final - w.y_final).max() / scale < 1e-10
        if w.ys is not None:
            assert np.abs(g.ys - w.ys).max() / scale < 1e-10
        assert (g.diverged == w.diverged).all()
        assert (g.n_padded_steps, g.n_padded_paths, g.retries) == \
            (w.n_padded_steps, w.n_padded_paths, w.retries)


_F32_SCRIPT = r"""
import asyncio, json
import jax, jax.numpy as jnp, numpy as np, torch
from repro.nsde import init_lsde as jinit, lsde_term as jterm
from repro.serving import AsyncSDESampleEngine as JAsync, SDESampleConfig as JConfig
from repro_torch.nsde import lsde_params_from_jax, lsde_term
from repro_torch.serving import AsyncSDESampleEngine, SDESampleConfig
assert not jax.config.jax_enable_x64
params = jinit(jax.random.PRNGKey(1), 1, 4, 8)
y0 = jnp.linspace(-0.5, 0.5, 4, dtype=jnp.float32)
reqs = [("ees25:use_kernels=True", 2.0, 8, 20, 1), ("ees25:use_kernels=True", 1.5, 6, 8, 2),
        ("ees27", 2.0, 16, 8, 3)]

async def serve(eng):
    async with eng:
        rids = [await eng.submit(s, t1=t1, n_steps=n, n_paths=p, seed=seed)
                for s, t1, n, p, seed in reqs]
        return [await eng.result(r, numpy=True) for r in rids]

want = asyncio.run(serve(JAsync(jterm(), y0, JConfig(slots=8, ticks_per_dispatch=2),
                                args=params)))
got = asyncio.run(serve(AsyncSDESampleEngine(
    lsde_term(), torch.from_numpy(np.asarray(y0)),
    SDESampleConfig(slots=8, ticks_per_dispatch=2),
    args=lsde_params_from_jax(params, device="cpu"), device="cpu")))
print(json.dumps([dict(dtype=str(g.y_final.dtype), ref_dtype=str(w.y_final.dtype),
                       err=float(np.abs(g.y_final - w.y_final).max()
                                 / max(1.0, np.abs(w.y_final).max())),
                       diverged=bool((g.diverged == w.diverged).all()))
                  for g, w in zip(got, want)]))
"""


def test_async_equals_reference_float32():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", _F32_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out) == 3
    for r in out:
        assert r["dtype"] == r["ref_dtype"] == "float32"
        assert r["err"] < 1e-4 and r["diverged"]


def test_results_stay_tensors_until_numpy(lsde64):
    _, _, tparams, ty0 = lsde64
    dev = _async(tparams, ty0, numpy=False)
    host = _async(tparams, ty0)
    for d, h in zip(dev, host):
        assert isinstance(d.y_final, torch.Tensor) and isinstance(h.y_final, np.ndarray)
        assert isinstance(d.diverged, torch.Tensor) and isinstance(h.diverged, np.ndarray)
        assert np.array_equal(d.y_final.numpy(), h.y_final)


def test_trainable_model_serves_without_grad(lsde64):
    """Parameters that require gradients serve through the async engine with
    no autograd graph on any result, the first dispatch of each callable
    (run in a worker thread) included."""
    _, _, tparams, ty0 = lsde64
    assert all(p.requires_grad for p in tparams.parameters())
    assert torch.is_grad_enabled()
    got = _async(tparams, ty0, numpy=False)
    for res in got:
        assert not res.y_final.requires_grad and res.y_final.grad_fn is None
        if res.ys is not None:
            assert not res.ys.requires_grad
    want = _sync(tparams, ty0)
    for g, w in zip(got, want):
        assert np.array_equal(g.y_final.numpy(), w.y_final)


def _small_term():
    return SDETerm(drift=lambda t, y, a: -0.5 * y,
                   diffusion=lambda t, y, a: 0.2 * torch.ones_like(y))


def test_submit_backpressure_awaits_space():
    async def main():
        cfg = SDESampleConfig(slots=4, max_queue_paths=8)
        async with AsyncSDESampleEngine(_small_term(), torch.ones(3), cfg,
                                        device="cpu") as eng:
            r1 = await eng.submit("ees25", t1=1.0, n_steps=8, n_paths=8)
            blocked = asyncio.create_task(
                eng.submit("ees25", t1=1.0, n_steps=8, n_paths=8))
            await asyncio.sleep(0)
            assert not blocked.done()  # parked on admission, no error
            await eng.result(r1)       # retirement frees capacity
            r2 = await asyncio.wait_for(blocked, 60)
            res = await eng.result(r2)
            assert res.y_final.shape == (8, 3)
    run_bounded(main())


def test_cancel_wakes_waiter_and_frees_capacity():
    async def main():
        cfg = SDESampleConfig(slots=2, max_queue_requests=1)
        async with AsyncSDESampleEngine(_small_term(), torch.ones(3), cfg,
                                        device="cpu") as eng:
            r1 = await eng.submit("ees25", t1=1.0, n_steps=8, n_paths=1000)
            blocked = asyncio.create_task(
                eng.submit("ees25", t1=1.0, n_steps=8, n_paths=2, seed=4))
            waiter = asyncio.create_task(eng.result(r1))
            await asyncio.sleep(0)
            assert eng.cancel(r1) is True
            with pytest.raises(asyncio.CancelledError):
                await waiter
            r2 = await asyncio.wait_for(blocked, 60)
            res = await eng.result(r2, numpy=True)
            assert res.y_final.shape[0] == 2
            with pytest.raises(asyncio.CancelledError):
                await eng.result(r1)   # stays cancelled on re-await
            with pytest.raises(KeyError, match="unknown request id"):
                await eng.result(999)
    run_bounded(main())


def test_submit_validation_errors_do_not_wait():
    async def main():
        async with AsyncSDESampleEngine(_small_term(), torch.ones(3),
                                        SDESampleConfig(slots=2), device="cpu") as eng:
            with pytest.raises(KeyError, match="unknown solver"):
                await eng.submit("not-a-solver", t1=1.0, n_steps=8, n_paths=2)
            with pytest.raises(ValueError, match="n_paths must be >= 1"):
                await eng.submit("ees25", t1=1.0, n_steps=8, n_paths=0)
            assert eng.pending() == {}
    run_bounded(main())


def test_drain_and_reuse_after_idle():
    async def main():
        async with AsyncSDESampleEngine(_small_term(), torch.ones(3),
                                        SDESampleConfig(slots=4), device="cpu") as eng:
            a = await eng.submit("ees25", t1=1.0, n_steps=8, n_paths=6)
            done = await eng.drain()
            assert sorted(k for k in done if k != "counters") == [a]
            b = await eng.submit("ees25", t1=1.0, n_steps=8, n_paths=2)
            done = await eng.drain()
            assert sorted(k for k in done if k != "counters") == [a, b]
            assert done["counters"]["retries"] == 0
        with pytest.raises(RuntimeError, match="closed"):
            await eng.submit("ees25", t1=1.0, n_steps=8, n_paths=2)
    run_bounded(main())


# -- warmup and the persistent kernel cache ------------------------------------

WARM = [dict(solver="ees25:use_kernels=True", t1=2.0, n_steps=8, n_paths=99),
        dict(solver="ees25:use_kernels=True", t1=1.5, n_steps=6, seed=3),
        dict(solver="ees27", t1=2.0, n_steps=16, save_every=4, priority=2),
        dict(solver="ees25", t1=1.0, n_steps=4)]


@pytest.mark.parametrize("tpd", [1, 2])
@pytest.mark.parametrize("bucketing", [True, False])
def test_warmup_count_equals_reference(lsde64, tpd, bucketing):
    params, y0, tparams, ty0 = lsde64
    jeng = JEngine(jterm(), y0, JConfig(slots=8, ticks_per_dispatch=tpd,
                                        dtype=jnp.float64, bucketing=bucketing),
                   args=params)
    teng = SDESampleEngine(lsde_term(), ty0, _cfg(ticks_per_dispatch=tpd,
                                                  bucketing=bucketing),
                           args=tparams, device="cpu")
    assert teng.warmup(WARM) == jeng.warmup(WARM)
    assert teng.warmup(WARM) == 0 == jeng.warmup(WARM)


def test_warmup_changes_no_sample(lsde64):
    _, _, tparams, ty0 = lsde64
    eng = SDESampleEngine(lsde_term(), ty0, _cfg(), args=tparams, device="cpu")
    assert eng.warmup(WARM) > 0
    keys = set(eng.executor._callables)
    rids = [eng.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se, seed=seed)
            for s, t1, n, p, se, seed in REQUESTS]
    done = eng.run()
    assert set(eng.executor._callables) == keys  # warmup covered every entry
    for rid, want in zip(rids, _sync(tparams, ty0)):
        assert np.array_equal(done[rid].y_final, want.y_final)
    async def warm_async():
        async with AsyncSDESampleEngine(lsde_term(), ty0, _cfg(), args=tparams,
                                        device="cpu") as a:
            return a.warmup(WARM), a.warmup(WARM)
    assert run_bounded(warm_async())[1] == 0


def test_executor_warmup_builds_nothing_off_cuda(monkeypatch):
    built = []
    monkeypatch.setattr(_build.CudaKernel, "lib", lambda self: built.append(self))
    ex = TickExecutor(_small_term(), torch.ones(3), device="cpu")
    bk = BucketKey("ees25:use_kernels=True", 0.0, 0.25, 8)
    assert ex.warmup(bk, 2, 8) is True and ex.warmup(bk, 2, 8) is False
    assert ex.has_compiled(bk, 2) and built == []
    assert ex.n_dispatches == 0


def test_compile_cache_dir_sets_the_library_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_library_dir", _build.BUILD_DIR)
    cfg = SDESampleConfig(slots=4, max_restarts=2, compile_cache_dir=str(tmp_path))
    assert cfg.max_restarts == 2
    SDESampleEngine(_small_term(), torch.ones(3), cfg, device="cpu")
    assert _build._library_dir == tmp_path
    lib = _build.CudaKernel("ws_stage_diag", "ws_stage_diag.cu", {}).library_path()
    assert lib.parent == tmp_path and lib.name.startswith("libws_stage_diag-")


# -- which kernels a spec launches ---------------------------------------------

_WRAPPERS = ("increment_diag", "increment_pre", "increment_general", "ws_stage_diag",
             "ws_stage_pre", "ws_stage_general", "axpy_chain")


def _noise_term(noise):
    drift = lambda t, y, a: 0.4 * (0.1 - y)  # noqa: E731
    if noise == "general":
        return SDETerm(drift, lambda t, y, a: torch.stack(
            [torch.ones_like(y), 0.5 * torch.cos(y)], -1), "general")
    if noise == "none":
        return SDETerm(drift, None, "none")
    if noise == "scalar":
        return SDETerm(drift, lambda t, y, a: 0.3 * y, "scalar")
    return SDETerm(drift, lambda t, y, a: 0.5 + 0.0 * y, noise)


SPEC_NOISE = [(spec, noise)
              for spec in ("ees25", "ees25:use_kernels=True", "ees27:use_kernels=True",
                           "reversible-heun:use_kernels=True",
                           "mcf-midpoint:use_kernels=True", "rk4:use_kernels=True",
                           "milstein:use_kernels=True")
              for noise in ("diagonal", "additive", "general", "none", "scalar")
              # Milstein rejects general noise (it needs Levy areas).
              if not (spec.startswith("milstein") and noise == "general")]


@pytest.mark.parametrize("spec,noise", SPEC_NOISE)
def test_spec_kernels_name_the_wrappers_a_dispatch_calls(monkeypatch, spec, noise):
    called = set()
    for name in _WRAPPERS:
        real = getattr(sde_ops._k, name)
        monkeypatch.setattr(sde_ops._k, name, lambda *a, _n=name, _f=real, **kw:
                            (called.add(_n), _f(*a, **kw))[1])
    real_w2n = w2n_ops.williamson2n
    monkeypatch.setattr(w2n_ops, "williamson2n", lambda *a, **kw:
                        (called.add("williamson2n"), real_w2n(*a, **kw))[1])
    ex = TickExecutor(_noise_term(noise), torch.ones(3), device="cpu",
                      noise_shape=(2,) if noise == "general" else None)
    keys = path_keys(PRNGKey(0, device="cpu"), 4)[None]
    out = ex.dispatch((spec, 0.0, 1.0, 4, None, None, None, None), keys)
    assert torch.isfinite(out.y_final).all()
    assert called == {k.name for k in spec_kernels(spec, noise)}
