"""Training of the port against the reference: the optimizers, the moment
loss and OU data, and ``make_sde_train_step`` on the Table-1 configuration
at a small size (``d_z=4``, ``width=8``, 16 paths).

Tolerances, and why:

* ``adamw`` / ``sgd`` / clipping / the cosine schedule on the same
  gradients: 1e-6 relative.  Both compute in float32 (the reference's
  moments are float32 whatever the parameter dtype); the global norm sums
  the leaves in another order, and torch's and XLA's float32 ``pow`` and
  ``sqrt`` may differ in the last bit;
* ``moment_mse`` 1e-12 relative (float64 reductions in another order);
  ``ou_paths`` bitwise (the same numpy calls in the same order);
* three train steps, float64 in this process: the first loss 1e-12
  relative (measured ~3e-16), later losses 1e-6 (measured <= 2e-8),
  parameters 1e-6 absolute (measured: one float32 ulp).  The gradients
  agree to ~1e-15 (see ``test_torch_adjoint.py``), but the optimizer
  computes every update in float32, so a last-bit flip of a float32
  gradient or moment moves a parameter by a float32 ulp, and the next
  loss sees it;
* three train steps, float32 in a subprocess without x64: loss and
  parameters 1e-4 relative (float32 rounding-order differences through
  three steps of a reversible solve).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nsde import init_lsde as jinit, lsde_readout as jreadout, lsde_term as jterm
from repro.nsde import moment_mse as jmoment_mse
from repro.nsde.data import ou_paths as jou_paths
from repro.optim import optimizers as jopt
from repro.train.trainer import make_sde_train_step as jmake_step
from repro_torch.core import prng
from repro_torch.nsde import lsde_params_from_jax, lsde_readout, lsde_term, moment_mse, ou_paths
from repro_torch.optim import adamw, clip_by_global_norm, cosine_schedule
from repro_torch.train import make_sde_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_Z, WIDTH, N_PATHS, T = 4, 8, 16, 2.0
SPECS = ["ees25:use_kernels=True", "reversible_heun:use_kernels=True",
         "mcf-euler:use_kernels=True", "mcf-midpoint:use_kernels=True"]
N_STEPS = {"ees25": 8, "reversible_heun": 8, "mcf-euler": 4, "mcf-midpoint": 4}


def ref_leaves(p):
    """The reference's LSDE params in the port's ``parameters()`` order."""
    layers = lambda name: [x for l in p[name] for x in (l["w"], l["b"])]  # noqa: E731
    return ([p["encoder"]["w"], p["encoder"]["b"]] + layers("drift")
            + layers("diff") + [p["readout"]["w"], p["readout"]["b"]])


# -- optimizers ----------------------------------------------------------------

def _grad_sequence(shapes, n, seed):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=s) * 10.0 ** rng.integers(-3, 2) for s in shapes]
            for _ in range(n)]


@pytest.mark.parametrize("make", [
    lambda m: m.adamw(1e-2),
    lambda m: m.adamw(3e-3, weight_decay=0.1, max_grad_norm=None),
    lambda m: m.adamw(m.cosine_schedule(1e-2, 2, 10)),
    lambda m: m.sgd(0.1, momentum=0.9),
    lambda m: m.sgd(0.05),
], ids=["adamw", "adamw-decay-noclip", "adamw-cosine", "sgd-momentum", "sgd"])
def test_optimizer_matches_reference_over_three_updates(make):
    from repro_torch.optim import optimizers as topt

    shapes = [(3, 4), (4,), (2,)]
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=s) for s in shapes]
    jo, to = make(jopt), make(topt)
    jp, tp = [jnp.asarray(x) for x in p0], [torch.from_numpy(x) for x in p0]
    js_, ts_ = jo.init(jp), to.init(tp)
    for grads in _grad_sequence(shapes, 3, 1):
        jp, js_, jn = jo.update([jnp.asarray(g) for g in grads], js_, jp)
        tp, ts_, tn = to.update([torch.from_numpy(g) for g in grads], ts_, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert int(ts_.step) == int(js_.step) == 3 and ts_.step.dtype == torch.int32


def test_clip_by_global_norm_matches_reference():
    grads = _grad_sequence([(5,), (2, 3)], 1, 2)[0]
    tg, tn = clip_by_global_norm([torch.from_numpy(g) for g in grads], 0.5)
    jg, jn = jopt.clip_by_global_norm([jnp.asarray(g) for g in grads], 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_cosine_schedule_matches_reference():
    t, j = cosine_schedule(1e-2, 3, 12), jopt.cosine_schedule(1e-2, 3, 12)
    for step in range(15):
        np.testing.assert_allclose(float(t(torch.tensor(step))), float(j(step)),
                                   rtol=1e-6)


def test_adamw_defaults_are_the_reference_defaults():
    import inspect

    for fn in ("adamw", "sgd", "cosine_schedule", "clip_by_global_norm"):
        from repro_torch.optim import optimizers as topt
        assert (inspect.signature(getattr(topt, fn)).parameters.keys()
                == inspect.signature(getattr(jopt, fn)).parameters.keys())
    assert {k: v.default for k, v in inspect.signature(adamw).parameters.items()} == \
        {k: v.default for k, v in inspect.signature(jopt.adamw).parameters.items()}


# -- loss and data -------------------------------------------------------------

def test_moment_mse_matches_reference():
    rng = np.random.default_rng(3)
    gen, tgt = rng.normal(size=(64, 3)), rng.normal(size=(100, 3)) * 2 + 1
    got = moment_mse(torch.from_numpy(gen), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got), float(jmoment_mse(gen, tgt)), rtol=1e-12)


def test_ou_paths_equal_reference():
    a = ou_paths(np.random.default_rng(0), 4096, 2, T=T)
    b = jou_paths(np.random.default_rng(0), 4096, 2, T=T)
    assert a.shape == (4096, 3) and np.array_equal(a, b)


# -- the train step ------------------------------------------------------------

def _target():
    return jou_paths(np.random.default_rng(0), 256, 2, T=T)[:, 1:]


def _ref_run(spec, n_steps, params, target, n_epochs):
    """The reference's Table-1 step (jitted), 3 epochs from PRNGKey(0)."""
    tgt = jnp.asarray(target)

    def loss_of_result(p, r):
        return jmoment_mse(jreadout(p, r.ys)[..., 0], tgt)

    opt = jopt.adamw(1e-2)
    state = opt.init(params)
    step = jax.jit(jmake_step(
        spec, jterm(), opt, y0_fn=lambda p: jnp.zeros(D_Z) + p["encoder"]["b"],
        loss_fn_result=loss_of_result, t0=0.0, t1=T, n_steps=n_steps,
        n_paths=N_PATHS, adjoint="reversible", save_every=n_steps // 2))
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        params, state, m = step(params, state, sub)
        out.append((float(m["loss"]), [np.asarray(x) for x in ref_leaves(params)],
                    bool(m["skipped"])))
    return out


def _port_step(spec, n_steps, params, target, dtype=torch.float64):
    tgt = torch.as_tensor(target, dtype=dtype)
    opt = adamw(1e-2)

    def loss_of_result(p, r):
        return moment_mse(lsde_readout(p, r.ys)[..., 0], tgt)

    step = make_sde_train_step(
        spec, lsde_term(), opt,
        y0_fn=lambda p: torch.zeros(D_Z, dtype=dtype) + p.encoder.b,
        loss_fn_result=loss_of_result, t0=0.0, t1=T, n_steps=n_steps,
        n_paths=N_PATHS, adjoint="reversible", save_every=n_steps // 2,
        device="cpu")
    return step, opt.init(list(params.parameters()))


def _port_run(spec, n_steps, jparams, target, n_epochs):
    params = lsde_params_from_jax(jparams, device="cpu")
    step, state = _port_step(spec, n_steps, params, target)
    key = prng.PRNGKey(0, device="cpu")
    out = []
    for _ in range(n_epochs):
        key, sub = prng.split(key)
        params, state, m = step(params, state, sub)
        out.append((float(m["loss"]), [p.detach().numpy().copy() for p in params.parameters()],
                    bool(m["skipped"])))
    return out


@pytest.fixture(scope="module")
def params64():
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                  jinit(jax.random.PRNGKey(0), 1, D_Z, WIDTH))


@pytest.mark.parametrize("spec", SPECS)
def test_train_steps_match_reference_float64(params64, spec):
    n = N_STEPS[spec.split(":")[0]]
    want = _ref_run(spec, n, params64, _target(), 3)
    got = _port_run(spec, n, params64, _target(), 3)
    for i, ((gl, gp, gs), (wl, wp, ws)) in enumerate(zip(got, want)):
        assert gs == ws is False
        np.testing.assert_allclose(gl, wl, rtol=1e-12 if i == 0 else 1e-6)
        for a, b in zip(gp, wp):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # three updates moved every parameter the loss reaches
    assert got[-1][0] != got[0][0]


def test_kernel_route_train_step_equals_plain(params64):
    """use_kernels=True (CPU twins) and the plain path train bitwise alike."""
    runs = [_port_run(spec, 4, params64, _target(), 2)
            for spec in ("mcf-midpoint:use_kernels=True", "mcf-midpoint")]
    for (al, ap, _), (bl, bp, _) in zip(*runs):
        assert al == bl and all(np.array_equal(a, b) for a, b in zip(ap, bp))


def test_guard_skips_a_nan_batch(params64):
    """A non-finite loss skips the update: parameters and optimizer state
    pass through unchanged, ``skipped`` is set, and no host sync decided it."""
    params = lsde_params_from_jax(params64, device="cpu")
    tgt = torch.as_tensor(_target())
    opt = adamw(1e-2)
    state = opt.init(list(params.parameters()))
    step = make_sde_train_step(
        "ees25", lsde_term(), opt, y0_fn=lambda p: torch.zeros(D_Z, dtype=torch.float64) + p.encoder.b,
        loss_fn_result=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt) * float("nan"),
        t0=0.0, t1=T, n_steps=4, n_paths=N_PATHS, save_every=2, device="cpu")
    before = [p.detach().clone() for p in params.parameters()]
    params, new_state, m = step(params, state, prng.PRNGKey(1, device="cpu"))
    assert m["skipped"].dtype == torch.bool and bool(m["skipped"])
    assert not torch.isfinite(m["loss"])
    for p, b in zip(params.parameters(), before):
        assert torch.equal(p, b)
    assert int(new_state.step) == 0
    for a, b in zip(new_state.mu + new_state.nu, state.mu + state.nu):
        assert torch.equal(a, b)
    # the unguarded step takes the poisoned update
    step = make_sde_train_step(
        "ees25", lsde_term(), opt, y0_fn=lambda p: torch.zeros(D_Z, dtype=torch.float64) + p.encoder.b,
        loss_fn_result=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt) * float("nan"),
        t0=0.0, t1=T, n_steps=4, n_paths=N_PATHS, save_every=2, guard=False, device="cpu")
    params, _, m = step(params, state, prng.PRNGKey(1, device="cpu"))
    assert "skipped" not in m and not torch.isfinite(params.drift.layers[0].w).all()


def test_table1_benchmark_runs_on_the_cpu(monkeypatch):
    """The port's Table-1 benchmark at a cut size (32 paths, 2 epochs)."""
    from repro_torch.benchmarks import table1_ou as t1

    monkeypatch.setattr(t1, "BATCH", 32)
    target = t1.target_paths()
    assert target.shape == (4096, 2)
    assert [s for _, s, _ in t1.solvers()] == [
        "reversible_heun:use_kernels=True", "mcf-euler:use_kernels=True",
        "mcf-midpoint:use_kernels=True", "ees25:use_kernels=True"]
    assert [n for _, _, n in t1.solvers()] == [24, 12, 6, 8]
    r = t1.train_one("ees25:use_kernels=True", 8, target, device="cpu", epochs=2)
    assert len(r.losses) == 2 and np.isfinite(r.losses).all() and r.skipped == 0
    assert r.loss == r.losses[-1] and r.seconds > 0


_F32_SCRIPT = r"""
import json, sys
sys.path.insert(0, "tests")
import jax, jax.numpy as jnp, numpy as np, torch
assert not jax.config.jax_enable_x64
import test_torch_train as T
params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                T.jinit(jax.random.PRNGKey(0), 1, T.D_Z, T.WIDTH))
target = T._target().astype(np.float32)
out = {}
for spec in T.SPECS:
    n = T.N_STEPS[spec.split(":")[0]]
    want = T._ref_run(spec, n, params, target, 3)
    tparams = T.lsde_params_from_jax(params, device="cpu")
    step, state = T._port_step(spec, n, tparams, target, dtype=torch.float32)
    key = T.prng.PRNGKey(0, device="cpu")
    loss_err, param_err = 0.0, 0.0
    for wl, wp, _ in want:
        key, sub = T.prng.split(key)
        tparams, state, m = step(tparams, state, sub)
        loss_err = max(loss_err, abs(float(m["loss"]) - wl) / abs(wl))
        for a, b in zip(tparams.parameters(), wp):
            scale = max(1.0, float(np.abs(b).max()))
            param_err = max(param_err, float(np.abs(a.detach().numpy() - b).max()) / scale)
    out[spec] = dict(loss=loss_err, params=param_err,
                     dtype=str(next(tparams.parameters()).dtype))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def float32_train():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", _F32_SCRIPT], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("spec", SPECS)
def test_train_steps_match_reference_float32(float32_train, spec):
    r = float32_train[spec]
    assert r["dtype"] == "torch.float32"
    assert r["loss"] < 1e-4 and r["params"] < 1e-4
