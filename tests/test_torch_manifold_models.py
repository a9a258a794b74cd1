"""The manifold models of the port against the reference's
(``repro.nsde.models:68-140``), float64 unless stated:

* the Kuramoto and sphere terms' drift, diffusion and algebra increment on
  carried parameters (``kuramoto_params_from_jax``,
  ``sphere_params_from_jax``), within 1e-12;
* ``_skew_basis_map`` bitwise, ``wrapped_energy_score`` within 1e-12;
* ``kuramoto_paths`` bitwise the reference's numpy;
* ``prng.randint`` bitwise ``jax.random.randint``, with x64 (int64, two
  64-bit draws) and without it (int32) at power-of-two and other spans;
* the ``init_*`` draws against the reference's without x64 (the
  benchmarks' float32; a subprocess), within 1e-5 of the largest weight:
  the bits and uniforms are exact, but torch's and XLA's float32
  ``erfinv`` differ by up to ~1e-5 relative in the far tails
  (``repro_torch.core.prng``).
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

import repro.nsde as J
from repro.nsde import data as jdata
from repro.nsde import models as jmodels
from repro_torch.core import prng
from repro_torch.nsde import data as tdata
from repro_torch.nsde import models as tmodels
import repro_torch.nsde as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _close(got, want, rtol=1e-12):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _jax_params(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


@pytest.fixture(scope="module")
def kuramoto_params():
    p = J.init_kuramoto_nsde(jax.random.PRNGKey(1), 5, width=16)
    p = _jax_params(p)
    return p, T.kuramoto_params_from_jax(p, device="cpu")


@pytest.fixture(scope="module")
def sphere_params():
    p = J.init_sphere_nsde(jax.random.PRNGKey(2), 4, width=16)
    p = dict(_jax_params(p), log_sigma=jnp.float64(-0.3))
    return p, T.sphere_params_from_jax(p, device="cpu")


def _kuramoto_state(rng, lead=(3,)):
    th = rng.uniform(-np.pi, np.pi, size=lead + (5,))
    om = rng.normal(size=lead + (5,))
    return th, om


def test_kuramoto_params_carry_across(kuramoto_params):
    jp, tp = kuramoto_params
    assert isinstance(tp, T.KuramotoNSDE)
    for name in ("drift", "diff"):
        layers = getattr(tp, name).layers
        assert len(layers) == len(jp[name])
        for lt, lj in zip(layers, jp[name]):
            np.testing.assert_array_equal(lt.w.detach().numpy(), np.asarray(lj["w"]))
            np.testing.assert_array_equal(lt.b.detach().numpy(), np.asarray(lj["b"]))
            assert lt.w.dtype == F64


@pytest.mark.parametrize("field", ["drift", "diffusion"])
def test_kuramoto_fields_match_reference(kuramoto_params, field):
    jp, tp = kuramoto_params
    th, om = _kuramoto_state(np.random.default_rng(0))
    want = getattr(J.kuramoto_nsde_term(), field)(0.3, (jnp.asarray(th), jnp.asarray(om)), jp)
    got = getattr(T.kuramoto_nsde_term(), field)(
        torch.tensor(0.3, dtype=F64), (torch.tensor(th), torch.tensor(om)), tp)
    _close(got, want)


def test_kuramoto_increment_and_group_match_reference(kuramoto_params):
    jp, tp = kuramoto_params
    rng = np.random.default_rng(1)
    th, om = _kuramoto_state(rng)
    dw = (rng.normal(size=th.shape), rng.normal(size=th.shape))
    jt, tt = J.kuramoto_nsde_term(), T.kuramoto_nsde_term()
    jy, ty = (jnp.asarray(th), jnp.asarray(om)), (torch.tensor(th), torch.tensor(om))
    want = jt.algebra_increment(0.1, jy, jp, 0.05, tuple(map(jnp.asarray, dw)))
    got = tt.algebra_increment(0.1, ty, tp, 0.05, tuple(map(torch.tensor, dw)))
    _close(got, want)
    _close(tt.group.exp_action(got, ty), jt.group.exp_action(want, jy))
    assert [g.name for g in tt.group.groups] == [g.name for g in jt.group.groups]
    assert tt.noise == jt.noise == "diagonal"


def test_sphere_params_carry_across(sphere_params):
    jp, tp = sphere_params
    assert isinstance(tp, T.SphereNSDE)
    assert float(tp.log_sigma.detach()) == float(jp["log_sigma"]) and tp.log_sigma.dim() == 0
    for lt, lj in zip(tp.drift.layers, jp["drift"]):
        np.testing.assert_array_equal(lt.w.detach().numpy(), np.asarray(lj["w"]))


@pytest.mark.parametrize("t", [0.0, 0.7, "per-path"])
def test_sphere_fields_match_reference(sphere_params, t):
    jp, tp = sphere_params
    rng = np.random.default_rng(2)
    y = rng.normal(size=(6, 4))
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    jt, tt = J.sphere_nsde_term(4), T.sphere_nsde_term(4)
    if t == "per-path":
        ts = rng.uniform(size=(6, 1))
        want = jax.vmap(lambda ti, yi: jt.drift(ti[0], yi, jp))(jnp.asarray(ts), jnp.asarray(y))
        got = tt.drift(torch.tensor(ts), torch.tensor(y), tp)
    else:
        want = jt.drift(jnp.float64(t), jnp.asarray(y), jp)
        got = tt.drift(torch.tensor(t, dtype=F64), torch.tensor(y), tp)
        _close(tt.drift(t, torch.tensor(y), tp), want)
    _close(got, want)
    _close(tt.diffusion(0.0, torch.tensor(y), tp), jt.diffusion(0.0, jnp.asarray(y), jp))
    dw = rng.normal(size=(6, 6))
    inc_t = tt.algebra_increment(0.2, torch.tensor(y), tp, 0.1, torch.tensor(dw))
    inc_j = jt.algebra_increment(0.2, jnp.asarray(y), jp, 0.1, jnp.asarray(dw))
    _close(inc_t, inc_j)
    assert (tt.noise, tt.group.n) == (jt.noise, jt.group.n) == ("general", 4)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_skew_basis_map_is_bitwise(n):
    to_t, m_t = tmodels._skew_basis_map(n)
    to_j, m_j = jmodels._skew_basis_map(n)
    assert m_t == m_j == n * (n - 1) // 2
    v = np.random.default_rng(n).normal(size=(2, 3, m_t))
    np.testing.assert_array_equal(to_t(torch.tensor(v)).numpy(), np.asarray(to_j(jnp.asarray(v))))


def test_sphere_gradient_flows_to_both_parameters(sphere_params):
    _, tp = sphere_params
    tt = T.sphere_nsde_term(4)
    y = torch.nn.functional.normalize(torch.randn(5, 4, dtype=F64), dim=-1)
    inc = tt.algebra_increment(0.0, y, tp, 0.1, torch.ones(5, 6, dtype=F64))
    grads = torch.autograd.grad(inc.square().sum(), list(tp.parameters()), allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("lead", [(), (7,)])
def test_wrapped_energy_score_matches_reference(lead):
    rng = np.random.default_rng(3)
    m, N = 4, 5
    sth = rng.uniform(-3 * np.pi, 3 * np.pi, size=(m,) + lead + (N,))
    som = rng.normal(size=(m,) + lead + (N,))
    tth = rng.uniform(-np.pi, np.pi, size=lead + (N,))
    tom = rng.normal(size=lead + (N,))
    got = T.wrapped_energy_score(*map(torch.tensor, (sth, som, tth, tom)))
    if lead:
        want = jax.vmap(lambda i: J.wrapped_energy_score(
            jnp.asarray(sth)[:, i], jnp.asarray(som)[:, i], jnp.asarray(tth)[i],
            jnp.asarray(tom)[i]))(jnp.arange(lead[0]))
    else:
        want = J.wrapped_energy_score(*map(jnp.asarray, (sth, som, tth, tom)))
    _close(got, want)


@pytest.mark.parametrize("kw", [dict(N=4, batch=3, n_steps=40),
                                dict(N=16, batch=32, n_steps=400, T=2.0, subsample=400),
                                dict(N=5, batch=2, n_steps=30, subsample=7, K=1.3)])
def test_kuramoto_paths_are_bitwise(kw):
    want = jdata.kuramoto_paths(np.random.default_rng(3), **kw)
    got = tdata.kuramoto_paths(np.random.default_rng(3), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


RANDINT_CASES = [(0, 4), (0, 7), (-5, 1000003), (3, 2 ** 20), (0, 2 ** 31 - 1),
                 (-2 ** 31, 2 ** 31 - 1), (5, 5), (7, 3)]


@pytest.mark.parametrize("lo,hi", RANDINT_CASES + [(0, 3 * 2 ** 40 + 7), (-2 ** 61, 2 ** 62 - 5)])
def test_randint_is_bitwise_with_x64(lo, hi):
    for seed in (0, 12345):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (3, 64), lo, hi))
        got = prng.randint(prng.PRNGKey(seed, device="cpu"), (3, 64), lo, hi, dtype=torch.int64)
        assert want.dtype == np.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_takes_a_key_batch():
    keys = prng.split(prng.PRNGKey(4, device="cpu"), 3)
    got = prng.randint(keys, (5,), 0, 9)
    want = jax.vmap(lambda k: jax.random.randint(k, (5,), 0, 9))(
        jax.random.split(jax.random.PRNGKey(4), 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_F32_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np, torch
assert not jax.config.jax_enable_x64
import repro.nsde as J
import repro_torch.nsde as T
from repro_torch.core import prng
from benchmarks import table4_sphere as jt4
from repro_torch.benchmarks import table4_sphere as tt4
out = {"randint": {}}
for lo, hi in %r:
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (3, 64), lo, hi))
    got = prng.randint(prng.PRNGKey(7, device="cpu"), (3, 64), lo, hi, dtype=torch.int32)
    out["randint"][f"{lo},{hi}"] = bool(want.dtype == np.int32
                                        and np.array_equal(got.numpy(), want))

def rel(t, j):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    return float(np.abs(t - j).max() / max(1e-30, np.abs(j).max()))

jk = J.init_kuramoto_nsde(jax.random.PRNGKey(0), 16, width=64)
tk = T.init_kuramoto_nsde(prng.PRNGKey(0, device="cpu"), 16, width=64)
js = J.init_sphere_nsde(jax.random.PRNGKey(1), 8, width=32)
ts = T.init_sphere_nsde(1, 8, width=32, device="cpu")
errs = [rel(l.w, p["w"]) for m, n in ((tk.drift, "drift"), (tk.diff, "diff"))
        for l, p in zip(m.layers, jk[n])]
errs += [rel(l.w, p["w"]) for l, p in zip(ts.drift.layers, js["drift"])]
errs += [rel(ts.log_sigma, js["log_sigma"])] if float(js["log_sigma"]) else []
out["init"] = max(errs)
out["zeros"] = bool(all(float(l.b.abs().max()) == 0 for l in tk.drift.layers)
                    and float(ts.log_sigma.detach()) == 0.0)
key = jax.random.PRNGKey(0)
jy0, jlab = jt4.data(key)
ty0, tlab = tt4.data(prng.PRNGKey(0, device="cpu"))
out["labels"] = bool(np.array_equal(tlab.numpy(), np.asarray(jlab)))
out["y0"] = rel(ty0, jy0)
k1, _ = jax.random.split(key)
out["head"] = rel(tt4.init_params(prng.PRNGKey(0, device="cpu")).head,
                  0.1 * jax.random.normal(k1, (8, 4)))
print(json.dumps(out))
""" % (RANDINT_CASES,)


@pytest.fixture(scope="module")
def float32_draws():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + REPO,
               JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", _F32_SCRIPT], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("lo,hi", RANDINT_CASES)
def test_randint_is_bitwise_without_x64(float32_draws, lo, hi):
    assert float32_draws["randint"][f"{lo},{hi}"]


def test_init_draws_match_the_reference(float32_draws):
    assert float32_draws["init"] < 1e-5
    assert float32_draws["zeros"]


def test_table4_data_and_head_match_the_reference(float32_draws):
    """Labels bitwise (``randint``); the anchors' and the noise's shared key
    reproduced (``y0`` within 1e-5, the normals' erfinv)."""
    assert float32_draws["labels"]
    assert float32_draws["y0"] < 1e-5 and float32_draws["head"] < 1e-5
