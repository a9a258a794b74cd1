"""Manifold terms through the port's ``SDESampleEngine`` against the
reference's (float64; tolerance 1e-10 relative to the largest sample: the
float64 normals differ by erfinv ulps, the sphere's exponentials by
rounding).

The engine derives the solver kind its term needs from the term — a term
with ``algebra_increment`` takes the manifold solvers — as the reference's
does (``repro/serving/sde_engine.py:298-299``), at submit time, in
``warmup`` and in the retry ladder's degraded resubmit:

* a ``Torus`` term and ``sphere_nsde_term(4)`` (carried parameters, general
  noise on the so(4) basis) serve ``cfees25`` / ``cfees27`` / ``cg2``
  requests equal to the reference engine's;
* ``"geo-em"`` on a Euclidean term, and ``"ees25"`` or an ``"auto"`` spec
  (which resolves to a Euclidean scheme) on a manifold term, fail with the
  reference's exact message;
* a manifold request whose first run diverges (an injected NaN) is retried
  with a halved step under its own kind, and its result equals a direct
  submission of the degraded spec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.nsde as JN
from repro.serving.sde_engine import SDESampleConfig as JConfig, SDESampleEngine as JEngine
import repro_torch.core as T
import repro_torch.nsde as TN
from repro_torch.serving import FaultConfig, SDESampleConfig, SDESampleEngine, inject_faults

F64 = torch.float64
REQUESTS = (("cfees25", 1.0, 8, 10, None, 3), ("cfees27", 2.0, 4, 7, 2, 4),
            ("cg2", 1.0, 6, 5, None, 5))


def _torus_terms():
    jt = J.ManifoldSDETerm(group=J.Torus(), drift=lambda t, y, a: 1.5 + jnp.sin(y),
                           diffusion=lambda t, y, a: 0.8 + 0.2 * jnp.cos(y))
    tt = T.ManifoldSDETerm(group=T.Torus(), drift=lambda t, y, a: 1.5 + torch.sin(y),
                           diffusion=lambda t, y, a: 0.8 + 0.2 * torch.cos(y))
    y0 = np.array([3.0, -3.1, 0.0, 1.0])
    return (jt, jnp.asarray(y0), None, None), (tt, torch.tensor(y0), None, None)


def _sphere_terms():
    p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                               JN.init_sphere_nsde(jax.random.PRNGKey(5), 4, width=16))
    y0 = np.array([0.5, -0.5, 0.5, 0.5])
    return ((JN.sphere_nsde_term(4), jnp.asarray(y0), p, (6,)),
            (TN.sphere_nsde_term(4), torch.tensor(y0),
             TN.sphere_params_from_jax(p, device="cpu"), (6,)))


TERMS = {"torus": _torus_terms, "sphere": _sphere_terms}


def _engines(kind, **cfg):
    (jt, jy, jp, ns), (tt, ty, tp, _) = TERMS[kind]()
    cfg = dict(dict(slots=8, ticks_per_dispatch=2), **cfg)
    jeng = JEngine(jt, jy, JConfig(dtype=jnp.float64, **cfg), args=jp, noise_shape=ns)
    teng = SDESampleEngine(tt, ty, SDESampleConfig(dtype=F64, **cfg), args=tp,
                           noise_shape=ns, device="cpu")
    return jeng, teng


def _submit(engine, requests=REQUESTS):
    return [engine.submit(s, t1=t1, n_steps=n, n_paths=p, save_every=se, seed=seed)
            for s, t1, n, p, se, seed in requests]


@pytest.mark.parametrize("kind", sorted(TERMS))
def test_manifold_requests_equal_the_reference_engine(kind):
    jeng, teng = _engines(kind)
    assert _submit(jeng) == _submit(teng)
    jdone = jeng.run()
    with torch.no_grad():
        tdone = teng.run()
    for rid, w in jdone.items():
        g = tdone[rid]
        assert g.y_final.shape == w.y_final.shape
        scale = max(1.0, np.abs(w.y_final).max())
        assert np.abs(g.y_final - w.y_final).max() / scale < 1e-10
        assert (w.ys is None) == (g.ys is None)
        if w.ys is not None:
            assert np.abs(g.ys - w.ys).max() / scale < 1e-10
        assert (g.diverged == w.diverged).all() and g.retries == w.retries == 0
        if kind == "torus":
            assert np.abs(g.y_final).max() <= np.pi
        else:
            assert np.abs(np.linalg.norm(g.y_final, axis=-1) - 1.0).max() < 1e-12
    assert (teng.executor.n_dispatches, teng.executor.n_ticks) == \
        (jeng.executor.n_dispatches, jeng.executor.n_ticks)


def _euclidean_engines():
    jt = J.SDETerm(drift=lambda t, y, a: -y, diffusion=lambda t, y, a: 0.1 * jnp.ones_like(y))
    tt = T.SDETerm(drift=lambda t, y, a: -y, diffusion=lambda t, y, a: 0.1 * torch.ones_like(y))
    return (JEngine(jt, jnp.zeros(2), JConfig(slots=4)),
            SDESampleEngine(tt, torch.zeros(2), SDESampleConfig(slots=4), device="cpu"))


@pytest.mark.parametrize("case", ["geo-em on euclidean", "ees25 on torus",
                                  "auto on sphere"])
def test_kind_mismatch_fails_with_the_reference_message(case):
    spec, _, where = case.split(" ")
    jeng, teng = _euclidean_engines() if where == "euclidean" else _engines(where)
    with pytest.raises(ValueError) as want:
        jeng.submit(spec, t1=1.0, n_steps=4, n_paths=2)
    with pytest.raises(ValueError) as got:
        teng.submit(spec, t1=1.0, n_steps=4, n_paths=2)
    assert str(got.value) == str(want.value)
    if spec == "auto":
        return  # warmup takes resolved specs only
    for eng, exc in ((teng, got), (jeng, want)):
        with pytest.raises(ValueError) as warm:
            eng.warmup([dict(solver=spec, t1=1.0, n_steps=4)])
        assert str(warm.value) == str(exc.value)


def test_warmup_takes_manifold_signatures():
    jeng, teng = _engines("sphere")
    sigs = [dict(solver="cfees25", t1=1.0, n_steps=8), dict(solver="cg2", t1=2.0, n_steps=8)]
    assert teng.warmup(sigs) == jeng.warmup(sigs)


def test_a_retried_manifold_request_keeps_its_kind():
    _, teng = _engines("sphere", slots=4, ticks_per_dispatch=1, bucketing=False)
    inject_faults(teng, FaultConfig(nan_slots=((0, 0, 1),)))
    rid = teng.submit("cfees25", t1=1.0, n_steps=4, n_paths=4, seed=9)
    with torch.no_grad():
        res = teng.run()[rid]
    assert res.retries == 1 and teng.counters["retries"] == 1
    assert not res.diverged.any()
    _, direct = _engines("sphere", slots=4, ticks_per_dispatch=1, bucketing=False)
    did = direct.submit("cfees25", t1=1.0, n_steps=8, n_paths=4, seed=9)
    with torch.no_grad():
        want = direct.run()[did]
    np.testing.assert_array_equal(res.y_final, want.y_final)
    assert np.abs(np.linalg.norm(res.y_final, axis=-1) - 1.0).max() < 1e-12
