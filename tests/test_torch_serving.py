"""The port's serving stack against the reference's and against its own
invariants.

The scheduler and bucketing layers are pure Python copies: driven by the same
operations they must produce the same plans, messages and bookkeeping.  The
engines, fed the same requests and seeds, must return the same samples: in
float64 here (tolerance 1e-10 relative: the float64 normals differ by erfinv
ulps) and in float32 in a subprocess without x64, the serving default (1e-4
relative to the largest sample).  Within the port, bucketed == exact,
``ticks_per_dispatch`` 1 == 2 and double buffering on == off hold bitwise,
and an engine's samples equal ``sdeint`` over ``path_keys(PRNGKey(seed), n)``.
"""
import dataclasses
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
from repro.serving import bucketing as jb
from repro.serving import scheduler as jsch
from repro.serving.sde_engine import SDESampleConfig as JConfig, SDESampleEngine as JEngine
from repro_torch.core import PRNGKey, SDETerm, path_keys, sdeint
from repro_torch.nsde import lsde_params_from_jax, lsde_term
from repro_torch.serving import bucketing as tb
from repro_torch.serving import scheduler as tsch
from repro_torch.serving import BucketKey, QueueFull, SDESampleConfig, SDESampleEngine, TickExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_Z, WIDTH = 4, 8


# -- scheduler / bucketing parity ------------------------------------------------

def _bucket_tuple(g):
    if isinstance(g, (jb.BucketKey, tb.BucketKey)):
        return ("bucket",) + dataclasses.astuple(g)
    return g


def _plan_view(plan):
    if plan is None:
        return None
    return ([[(p.request.request_id, i) for p, i in tick] for tick in plan.ticks],
            plan.tick_sigs, _bucket_tuple(plan.group), plan.reserved)


def _drive(mod, bmod, seed, n_ops=60):
    """Apply one seeded random sequence of submit/plan/deliver/cancel/release
    operations to a scheduler; return the observable trace."""
    rng = np.random.default_rng(seed)
    cfg = bmod.BucketingConfig(enabled=bool(seed % 2), min_steps=4)
    sch = mod.Scheduler(max_requests=6, group_key=lambda s: bmod.group_key(s, cfg))
    trace, outstanding, next_id = [], [], 0
    for _ in range(n_ops):
        op = rng.choice(["submit", "submit", "plan", "deliver", "cancel", "release"])
        if op == "submit":
            n_steps = int(rng.choice([3, 4, 6, 8]))
            spec = str(rng.choice(["ees25", "ees27", "ees25:use_kernels=True"]))
            save = 2 if (n_steps % 2 == 0 and rng.random() < 0.3) else None
            try:
                req = mod.make_request(
                    next_id, spec, term_kind="euclidean", t1=0.5 * n_steps,
                    n_steps=n_steps, n_paths=int(rng.integers(1, 12)),
                    save_every=save, priority=int(rng.integers(0, 2)))
                sch.enqueue(req)
                next_id += 1
                trace.append(("submit", req.request_id))
            except mod.QueueFull as e:
                trace.append(("full", str(e)))
        elif op == "plan":
            plan = sch.plan(4, int(rng.integers(1, 4)), reserve=True)
            if plan is not None:
                outstanding.append(plan)
            trace.append(("plan", _plan_view(plan)))
        elif op == "deliver" and outstanding:
            plan = outstanding.pop(0)
            outs = {"y_final": np.zeros((plan.n_ticks, plan.slots, 1)), "ys": None}
            trace.append(("deliver", sch.deliver(plan, outs)))
        elif op == "release" and outstanding:
            sch.release(outstanding.pop())
            trace.append(("release",))
        elif op == "cancel" and next_id:
            rid = int(rng.integers(0, next_id))
            try:
                trace.append(("cancel", rid, sch.cancel(rid)))
            except KeyError:
                trace.append(("cancel", rid, "unknown"))
        pend = sch.pending(detail=True)
        trace.append(("pending", {k: {f: _bucket_tuple(v) for f, v in d.items()}
                                  for k, d in pend.items()}))
    trace.append(("done", sorted(sch.done)))
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_plan_sequence_equals_reference(seed):
    assert _drive(tsch, tb, seed) == _drive(jsch, jb, seed)


@pytest.mark.parametrize("kwargs", [
    dict(n_paths=0), dict(n_steps=0), dict(t1=0.0), dict(rtol=1e-3),
    dict(save_every=3), dict(save_every=0), dict(priority=1.5),
    dict(deadline_ms=0.0), dict(solver="ees25:adaptive", save_every=2),
    dict(solver="ees25:adaptive", save_at=[[0.1]]),
    dict(solver="ees25:adaptive", save_at=[]),
    dict(solver="ees25:adaptive", save_at=[5.0]),
    dict(term_kind="manifold")])
def test_make_request_errors_equal_reference(kwargs):
    base = dict(solver="ees25", term_kind="euclidean", t1=1.0, n_steps=4, n_paths=2)
    base.update(kwargs)
    solver = base.pop("solver")
    with pytest.raises(ValueError) as want:
        jsch.make_request(0, solver, **base)
    with pytest.raises(ValueError) as got:
        tsch.make_request(0, solver, **base)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_steps", [1, 5, 8, 9, 100])
@pytest.mark.parametrize("save_every", [None, 1])
def test_bucketing_equals_reference(n_steps, save_every):
    assert tb.ladder_rung(n_steps, 4) == jb.ladder_rung(n_steps, 4)
    sig = ("ees25", 0.0, 0.25 * n_steps, n_steps, save_every, None, None, None)
    for enabled in (True, False):
        tcfg, jcfg = tb.BucketingConfig(enabled, 8), jb.BucketingConfig(enabled, 8)
        assert _bucket_tuple(tb.group_key(sig, tcfg)) == _bucket_tuple(jb.group_key(sig, jcfg))
    with pytest.raises(ValueError) as want:
        jb.BucketingConfig(min_steps=0)
    with pytest.raises(ValueError) as got:
        tb.BucketingConfig(min_steps=0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("attempt", [0, 1, 2])
@pytest.mark.parametrize("solver", ["ees25", "ees27", "ees25:use_kernels=True"])
def test_retry_ladder_equals_reference(attempt, solver):
    kw = dict(term_kind="euclidean", t1=1.0, n_steps=4, n_paths=2, seed=3)
    want = jsch.RetryPolicy().degrade(jsch.make_request(0, solver, **kw), attempt)
    got = tsch.RetryPolicy().degrade(tsch.make_request(0, solver, **kw), attempt)
    assert got == want


# -- engines -------------------------------------------------------------------

REQUESTS = [  # (solver, t1, n_steps, n_paths, save_every, seed, priority)
    ("ees25:use_kernels=True", 2.0, 8, 20, None, 1, 0),   # bucket (h=0.25, 8)
    ("ees25:use_kernels=True", 1.5, 6, 8, None, 2, 0),    # same bucket
    ("ees27", 2.0, 16, 8, 4, 3, 0),                       # exact (saves)
    ("ees25", 1.0, 4, 5, None, 4, 1),                     # bucket (h=0.25, 8)
]


def _submit_all(engine, requests=REQUESTS):
    return [engine.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se,
                          seed=seed, priority=pr)
            for s, t1, n, p, se, seed, pr in requests]


@pytest.fixture(scope="module")
def lsde64():
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64), jinit(jax.random.PRNGKey(1), 1, D_Z, WIDTH))
    y0 = jnp.linspace(-0.5, 0.5, D_Z)
    return params, y0, lsde_params_from_jax(params, device="cpu"), torch.from_numpy(np.array(y0))


def _port_engine(tparams, ty0, **cfg):
    cfg = dict(dict(slots=8, ticks_per_dispatch=2, dtype=torch.float64), **cfg)
    return SDESampleEngine(lsde_term(), ty0, SDESampleConfig(**cfg), args=tparams,
                           device="cpu")


def test_engine_equals_reference_float64(lsde64):
    params, y0, tparams, ty0 = lsde64
    jeng = JEngine(jterm(), y0, JConfig(slots=8, ticks_per_dispatch=2,
                                        dtype=jnp.float64), args=params)
    teng = _port_engine(tparams, ty0)
    jids, tids = _submit_all(jeng), _submit_all(teng)
    assert jids == tids
    with torch.no_grad():
        tdone = teng.run()
    jdone = jeng.run()
    for rid in tids:
        w, g = jdone[rid], tdone[rid]
        scale = max(1.0, np.abs(w.y_final).max())
        assert np.abs(g.y_final - w.y_final).max() / scale < 1e-10
        assert (w.ys is None) == (g.ys is None)
        if w.ys is not None:
            assert np.abs(g.ys - w.ys).max() / scale < 1e-10
        assert (g.diverged == w.diverged).all()
        assert _bucket_tuple(g.bucket) == _bucket_tuple(w.bucket)
        assert (g.n_padded_steps, g.n_padded_paths, g.retries) == \
            (w.n_padded_steps, w.n_padded_paths, w.retries)
    assert (teng.executor.n_dispatches, teng.executor.n_ticks) == \
        (jeng.executor.n_dispatches, jeng.executor.n_ticks)


_F32_SCRIPT = r"""
import json
import jax, jax.numpy as jnp, numpy as np, torch
from repro.nsde import init_lsde as jinit, lsde_term as jterm
from repro.serving.sde_engine import SDESampleConfig as JConfig, SDESampleEngine as JEngine
from repro_torch.nsde import lsde_params_from_jax, lsde_term
from repro_torch.serving import SDESampleConfig, SDESampleEngine
assert not jax.config.jax_enable_x64
params = jinit(jax.random.PRNGKey(1), 1, 4, 8)
y0 = jnp.linspace(-0.5, 0.5, 4, dtype=jnp.float32)
reqs = [("ees25:use_kernels=True", 2.0, 8, 20, 1), ("ees25:use_kernels=True", 1.5, 6, 8, 2)]
jeng = JEngine(jterm(), y0, JConfig(slots=8, ticks_per_dispatch=2), args=params)
teng = SDESampleEngine(lsde_term(), torch.from_numpy(np.asarray(y0)),
                       SDESampleConfig(slots=8, ticks_per_dispatch=2),
                       args=lsde_params_from_jax(params, device="cpu"), device="cpu")
for e in (jeng, teng):
    for s, t1, n, p, seed in reqs:
        e.submit(s, t1=t1, n_steps=n, n_paths=p, seed=seed)
with torch.no_grad():
    tdone = teng.run()
jdone = jeng.run()
out = {}
for rid in jdone:
    w, g = jdone[rid], tdone[rid]
    out[rid] = dict(dtype=str(g.y_final.dtype), ref_dtype=str(w.y_final.dtype),
                    err=float(np.abs(g.y_final - w.y_final).max() / max(1.0, np.abs(w.y_final).max())),
                    bucket=str(g.bucket) == str(w.bucket).replace("repro.", "repro_torch."),
                    diverged=bool((g.diverged == w.diverged).all()))
print(json.dumps(out))
"""


def test_engine_equals_reference_float32():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", _F32_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out) == 2
    for r in out.values():
        assert r["dtype"] == "float32" and r["ref_dtype"] == "float32"
        assert r["err"] < 1e-4 and r["diverged"]


@pytest.mark.parametrize("variant", [dict(bucketing=False), dict(ticks_per_dispatch=1),
                                     dict(double_buffer=False),
                                     dict(guard_threshold=None)])
def test_engine_invariants_bitwise(lsde64, variant):
    _, _, tparams, ty0 = lsde64
    base, other = _port_engine(tparams, ty0), _port_engine(tparams, ty0, **variant)
    ids = _submit_all(base)
    _submit_all(other)
    with torch.no_grad():
        a, b = base.run(), other.run()
    for rid in ids:
        assert np.array_equal(a[rid].y_final, b[rid].y_final)
        if a[rid].ys is not None:
            assert np.array_equal(a[rid].ys, b[rid].ys)
        if variant.get("guard_threshold", 1) is None:
            assert b[rid].diverged is None
        elif "bucketing" in variant:
            assert b[rid].bucket is None and b[rid].n_padded_steps == 0


def test_engine_samples_equal_sdeint(lsde64):
    _, _, tparams, ty0 = lsde64
    eng = _port_engine(tparams, ty0)
    ids = _submit_all(eng)
    with torch.no_grad():
        done = eng.run()
        for rid, (s, t1, n, p, se, seed, _) in zip(ids, REQUESTS):
            ref = sdeint(lsde_term(), s, 0.0, t1, n, ty0, args=tparams,
                         batch_keys=path_keys(PRNGKey(seed, device="cpu"), p),
                         save_every=se, device="cpu")
            torch.testing.assert_close(torch.from_numpy(done[rid].y_final),
                                       ref.y_final, rtol=1e-12, atol=1e-12)


def _blowup_engine(**cfg):
    term = SDETerm(drift=lambda t, y, a: y ** 3, diffusion=lambda t, y, a: 0.1 * y)
    return SDESampleEngine(term, torch.tensor([2.0, 3.0], dtype=torch.float64),
                           SDESampleConfig(slots=4, dtype=torch.float64, **cfg),
                           device="cpu")


def test_retry_ladder_and_counters():
    eng = _blowup_engine()
    rid = eng.submit("ees25", t1=2.0, n_steps=4, n_paths=3, seed=7)
    done = eng.run()
    res = done[rid]
    assert res.retries == 2 and res.diverged.all()
    c = eng.pending(detail=True)["counters"]
    assert (c["retries"], c["diverged_requests"], c["diverged_paths"]) == (2, 3, 9)
    quiet = _blowup_engine(retry_policy=None)
    rid = quiet.submit("ees25", t1=2.0, n_steps=4, n_paths=3)
    assert quiet.run()[rid].retries == 0


def test_admission_cancel_and_deadlines():
    t = [0.0]
    term = SDETerm(drift=lambda t_, y, a: -y, diffusion=lambda t_, y, a: 0.1 * y)
    eng = SDESampleEngine(term, torch.zeros(2), SDESampleConfig(
        slots=4, max_queue_requests=2), clock=lambda: t[0], device="cpu")
    a = eng.submit("ees25", t1=1.0, n_steps=2, n_paths=3)
    b = eng.submit("ees27", t1=1.0, n_steps=2, n_paths=3, deadline_ms=10.0)
    with pytest.raises(QueueFull, match="max_requests=2"):
        eng.submit("ees25", t1=1.0, n_steps=2, n_paths=1)
    assert eng.cancel(a) and not eng.cancel(a)
    with pytest.raises(KeyError):
        eng.cancel(99)
    t[0] = 1.0  # past b's deadline
    done = eng.run()
    assert done[b].timed_out and done[b].y_final is None and a not in done
    assert eng.pending() == {} and eng.executor.n_dispatches == 0


def test_executor_cache_and_counters(lsde64):
    _, _, tparams, ty0 = lsde64
    ex = TickExecutor(lsde_term(), ty0, args=tparams, dtype=torch.float64,
                      guard=1e6, device="cpu")
    bk = BucketKey("ees25", 0.0, 0.25, 8)
    keys = path_keys(PRNGKey(0, device="cpu"), 8).reshape(2, 4, 2)
    assert not ex.has_compiled(bk, 2)
    with pytest.raises(ValueError, match="needs active_steps"):
        ex.dispatch(bk, keys)
    with torch.no_grad():
        out = ex.dispatch(bk, keys, (8, 3))
    assert ex.has_compiled(bk, 2) and (ex.n_dispatches, ex.n_ticks) == (1, 2)
    assert out.y_final.shape == (2, 4, D_Z) and out.diverged.shape == (2, 4)
    assert out.ys is None


def test_engine_serves_a_trainable_model_without_no_grad(lsde64):
    """Parameters that require gradients (an nn.Module as built) serve as the
    reference's do, without the caller turning autograd off, and give the
    same samples as a run under no_grad."""
    _, _, tparams, ty0 = lsde64
    assert all(p.requires_grad for p in tparams.parameters())
    eng, ref = _port_engine(tparams, ty0), _port_engine(tparams, ty0)
    ids = _submit_all(eng)
    assert _submit_all(ref) == ids
    done = eng.run()
    with torch.no_grad():
        want = ref.run()
    for rid in ids:
        assert np.array_equal(done[rid].y_final, want[rid].y_final)
