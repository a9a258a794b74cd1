"""The Virtual Brownian Tree and adaptive realization of the port against the
reference (``tests/test_vbt_adaptive.py``'s cases).

float64 in-process (x64 on); float32 in a subprocess against the reference
without x64, its default (its float32 states cannot run with x64 on: the
controller's float64 step sizes promote them).  Tolerances:

* tree values: 1e-13 (float64) / 1e-6 (float32) absolute — torch's and
  XLA's ``erfinv`` differ in the last bits, and a value sums ``depth + 1``
  scaled normals;
* realized grids: equal per-path accepted and rejected counts, ``ts`` and
  ``hs`` within 1e-8.  The controller amplifies rounding: every trial's
  step size depends on the last error estimate, a cancellation, and the
  tree's values at the new times, so a difference in the last bit grows
  several-fold a trial.  The reference's own counts change under a one-ulp
  change of its inputs once a path takes tens of trials
  (``test_reference_counts_change_under_one_ulp``: on the transient term
  at rtol 1e-3, ees25, heun, milstein and srk with ``y0`` one ulp up; on
  the Table-1 model, ees25 with ``h0`` one ulp up).  The schemes are held
  at tolerances where a path takes a few tens of trials: rtol 1e-2 (EES, Milstein) and 1e-1 (the Butcher RK
  and SRA1, whose first-order companion error estimates take more);
* float32 against the no-x64 reference (float32 times there, float64 in
  the port): equal counts at rtol 1e-2 and states within 1e-3.

Within the port (no tolerance): ``W(t0) == 0``, bulk rows equal per-step
queries, a key batch equals per-key trees.
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

import repro.core as J
import repro_torch.core as T
from repro_torch.core import brownian as tbr
from repro_torch.core import prng
from repro_torch.core.pytree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = {torch.float32: 1e-6, torch.float64: 1e-13}
JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}
KEY = jax.random.PRNGKey(0)


def _tkey(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jrate(t, a):
    return a["nu"] * (1.0 + 40.0 * jnp.exp(-(((t - 0.5) / 0.05) ** 2)))


def trate(t, a):
    return a["nu"] * (1.0 + 40.0 * torch.exp(-(((t - 0.5) / 0.05) ** 2)))


def terms(kind, noise="diagonal"):
    """``(reference term, port term)``: ``"ou"`` (tests/test_vbt_adaptive.py)
    or ``"transient"`` (the stiff transient of tests/test_realized_grid.py);
    additive noise for SRA1."""
    def make(mod, np_, rate):
        if kind == "ou":
            drift = lambda t, y, a: a["nu"] * (a["mu"] - y)  # noqa: E731
        else:
            drift = lambda t, y, a: rate(t, a) * (a["mu"] - y)  # noqa: E731
        if noise == "additive":
            diff = lambda t, y, a: a["sigma"] * np_.ones_like(y)  # noqa: E731
        else:
            diff = lambda t, y, a: a["sigma"] * (1.0 + 0.1 * np_.tanh(y))  # noqa: E731
        return mod.SDETerm(drift=drift, diffusion=diff, noise=noise)

    return make(J, jnp, jrate), make(T, torch, trate)


JARGS = {"nu": jnp.float64(0.7), "mu": jnp.float64(0.2), "sigma": jnp.float64(0.4)}
TARGS = {"nu": 0.7, "mu": 0.2, "sigma": 0.4}


def jvbt(key, shape=(3,), dtype=jnp.float64, t1=1.0, tol=None):
    return J.virtual_brownian_tree(key, 0.0, t1, shape=shape, dtype=dtype, tol=tol)


def tvbt(key, shape=(3,), dtype=torch.float64, t1=1.0, tol=None):
    return T.virtual_brownian_tree(key, 0.0, t1, shape=shape, dtype=dtype, tol=tol)


# -- the tree -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tree_values_match_reference(dtype):
    """weval at many t (shared and per-path), increment_over and levy_area,
    for a batch of per-path keys."""
    keys = jax.random.split(KEY, 5)
    tree = tvbt(_tkey(keys), dtype=dtype)
    one = lambda k: jvbt(k, dtype=JNP[dtype])  # noqa: E731
    for t in (0.0, 0.013, 0.1, 0.25, 0.37, 0.5, 0.731, 0.9, 1.0):
        want = jax.vmap(lambda k: one(k).weval(t))(keys)
        np.testing.assert_allclose(_np(tree.weval(t)), want, rtol=0,
                                   atol=ATOL[dtype])
    s = np.array([0.0, 0.11, 0.3, 0.5, 0.62])
    t = s + np.array([0.5, 0.05, 0.21, 0.5, 0.001])
    ts, tt = torch.from_numpy(s), torch.from_numpy(t)
    checks = [
        (tree.weval(tt), jax.vmap(lambda k, x: one(k).weval(x))(keys, t)),
        (tree.increment_over(ts, tt),
         jax.vmap(lambda k, a, b: one(k).increment_over(a, b))(keys, s, t)),
        (tree.levy_area(ts, tt),
         jax.vmap(lambda k, a, b: one(k).levy_area(a, b))(keys, s, t)),
    ]
    for got, want in checks:
        assert got.dtype == dtype and got.shape == (5, 3)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATOL[dtype])


def test_w_t0_is_exactly_zero():
    keys = _tkey(jax.random.split(KEY, 4))
    for dtype in (torch.float32, torch.float64):
        assert torch.equal(tvbt(keys, dtype=dtype).weval(0.0),
                           torch.zeros(4, 3, dtype=dtype))


def test_increments_telescope():
    """Refining [s, u] at any midpoint leaves the total increment fixed."""
    tree = tvbt(_tkey(KEY))
    for s, m, u in [(0.0, 0.5, 1.0), (0.25, 0.375, 0.5), (0.2, 0.33, 0.81)]:
        whole = tree.increment_over(s, u)
        parts = tree.increment_over(s, m) + tree.increment_over(m, u)
        torch.testing.assert_close(whole, parts, rtol=0, atol=1e-12)


@pytest.mark.parametrize("per_path", [False, True], ids=["shared", "per-path"])
def test_bulk_rows_equal_per_step_queries(per_path):
    """grid_increments / grid_levy_increments row n is bitwise
    grid_increment / grid_levy_increment(ts, n), also across bulk passes."""
    keys = prng.split(prng.PRNGKey(3, device="cpu"), 4)
    tree = tvbt(keys)
    base = torch.tensor([0.0, 0.1, 0.35, 0.6, 0.61, 1.0], dtype=torch.float64)
    ts = (base + torch.linspace(0, 0.02, 4, dtype=torch.float64)[:, None]).clamp(max=1.0) \
        if per_path else base
    bulk = tree.grid_increments(ts)
    dws, dhs = tree.grid_levy_increments(ts)
    saved = tbr.BULK_PASS_ELEMENTS
    try:
        tbr.BULK_PASS_ELEMENTS = 12  # one node a pass
        passes = tree.grid_increments(ts, n_rows=4)
    finally:
        tbr.BULK_PASS_ELEMENTS = saved
    assert bulk.shape == (5, 4, 3) and passes.shape == (4, 4, 3)
    for n in range(5):
        assert torch.equal(bulk[n], tree.grid_increment(ts, n))
        dw, dh = tree.grid_levy_increment(ts, n)
        assert torch.equal(dws[n], dw) and torch.equal(dhs[n], dh)
    assert torch.equal(passes, bulk[:4])


def test_key_batch_equals_per_key_trees():
    keys = prng.split(prng.PRNGKey(5, device="cpu"), 3)
    times = torch.tensor([0.2, 0.55, 0.9], dtype=torch.float64)
    batched = tvbt(keys).weval(times)
    levy = tvbt(keys).levy_area(times - 0.1, times)
    for i in range(3):
        assert torch.equal(batched[i], tvbt(keys[i]).weval(float(times[i])))
        assert torch.equal(levy[i], tvbt(keys[i]).levy_area(
            float(times[i] - 0.1), float(times[i])))


def test_pytree_shapes_match_reference():
    shape = ((2,), (4,))
    got = tvbt(_tkey(KEY), shape=shape).increment_over(0.2, 0.7)
    want = jvbt(KEY, shape=shape).increment_over(0.2, 0.7)
    assert got[0].shape == (2,) and got[1].shape == (4,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=1e-13)
    # leaves come from independent streams
    assert not torch.equal(got[0], tvbt(_tkey(KEY), shape=(2,)).increment_over(0.2, 0.7))


def test_fixed_grid_driver_queries_match_reference():
    """BrownianPath.t_of / .path / .increment_over and PaddedBrownianPath.t_of."""
    jb = J.brownian_path(KEY, 0.0, 2.0, 8, shape=(3,), dtype=jnp.float64)
    tb = T.brownian_path(_tkey(KEY), 0.0, 2.0, 8, shape=(3,), dtype=torch.float64)
    assert tb.t_of(3) == float(jb.t_of(3))
    np.testing.assert_allclose(_np(tb.path()), jb.path(), rtol=0, atol=1e-13)
    assert tb.path() is tb.path()  # realized once, cached
    for s, t in [(0.0, 2.0), (0.5, 1.25), (0.74, 1.26)]:
        np.testing.assert_allclose(_np(tb.increment_over(s, t)),
                                   jb.increment_over(s, t), rtol=0, atol=1e-13)
    jp = J.padded_brownian_path(KEY, 0.0, 0.25, 8, shape=(3,))
    tp = T.padded_brownian_path(_tkey(KEY), 0.0, 0.25, 8, shape=(3,))
    assert tp.t_of(5) == float(jp.t_of(5))
    assert isinstance(tb, T.BrownianDriver) and isinstance(tvbt(_tkey(KEY)), T.BrownianDriver)


# -- realized grids -----------------------------------------------------------

# (spec, rtol, noise): see the module docstring for the tolerances.
REALIZE_CASES = [("ees25", 1e-2, "diagonal"), ("ees27", 1e-2, "diagonal"),
                 ("heun", 1e-1, "diagonal"), ("milstein", 1e-2, "diagonal"),
                 ("srk", 1e-1, "additive")]


@pytest.mark.parametrize("spec,rtol,noise", REALIZE_CASES,
                         ids=[c[0] for c in REALIZE_CASES])
def test_realize_grid_matches_reference(spec, rtol, noise):
    """Per path: ts, hs and both counts, on the reference's transient term."""
    jt, tt = terms("transient", noise)
    keys = jax.random.split(KEY, 8)
    want = jax.vmap(lambda k: J.realize_grid(
        spec, jt, jnp.ones(3), jvbt(k), JARGS, rtol=rtol, atol=rtol * 1e-2,
        max_steps=128))(keys)
    got = T.realize_grid(spec, tt, torch.ones(8, 3, dtype=torch.float64),
                         tvbt(_tkey(keys)), TARGS, rtol=rtol, atol=rtol * 1e-2,
                         max_steps=128)
    np.testing.assert_array_equal(_np(got.n_accepted), want.n_accepted)
    np.testing.assert_array_equal(_np(got.n_rejected), want.n_rejected)
    assert got.grid.ts.shape == (8, 129) and got.grid.hs.shape == (8, 128)
    np.testing.assert_allclose(_np(got.grid.ts), want.grid.ts, rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(got.grid.hs), want.grid.hs, rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(got.y_final), want.y_final, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(_np(got.t_final), 1.0)
    assert got.grid.n_active == int(np.max(want.n_accepted))


# (term, spec, noise, the input moved one ulp up, least paths of 16 whose
# counts change), all at rtol 1e-3.
ULP_CASES = [("transient", "ees25", "diagonal", "y0", 1),
             ("transient", "heun", "diagonal", "y0", 8),
             ("transient", "milstein", "diagonal", "y0", 8),
             ("transient", "srk", "additive", "y0", 8),
             ("table1", "ees25", "diagonal", "h0", 8)]


@pytest.mark.parametrize("kind,spec,noise,moved,least", ULP_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in ULP_CASES])
def test_reference_counts_change_under_one_ulp(kind, spec, noise, moved, least):
    """Why count parity is tested at coarse tolerances: at rtol 1e-3 the
    reference's own accepted and rejected counts change on some paths when
    one input moves by one ulp.  The Table-1 case is the Langevin model
    (d_z = 16, width 32) that the card's adaptive phase serves."""
    if kind == "table1":
        from repro.nsde import init_lsde, lsde_term
        term = lsde_term()
        args = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                      init_lsde(jax.random.PRNGKey(0), 1, 16, 32))
        y0, t1, h0 = jnp.zeros(16), 2.0, 2.0 / 16
        opts = dict(max_steps=256)
    else:
        term, _ = terms("transient", noise)
        args, y0, t1, h0 = JARGS, jnp.ones(3), 1.0, None
        opts = dict(atol=1e-5, max_steps=256)
    keys = jax.random.split(KEY, 16)
    counts = []
    for up in (False, True):
        y = jnp.nextafter(y0, 2.0) if up and moved == "y0" else y0
        h = float(np.nextafter(h0, t1)) if up and moved == "h0" else h0
        r = jax.vmap(lambda k: J.realize_grid(
            spec, term, y, jvbt(k, shape=y0.shape, t1=t1), args, rtol=1e-3,
            h0=h, **opts))(keys)
        counts.append((np.asarray(r.n_accepted), np.asarray(r.n_rejected)))
    (a0, r0), (a1, r1) = counts
    changed = int(((a0 != a1) | (r0 != r1)).sum())
    assert changed >= least, (spec, changed)


@pytest.mark.parametrize("bounded", [False, True])
def test_integrate_adaptive_matches_reference(bounded):
    """y_final and the save_at dense output, on the OU term."""
    jt, tt = terms("ou")
    keys = jax.random.split(KEY, 6)
    save_at = [0.0, 0.1, 0.25, 0.5, 0.9, 1.0]
    want = jax.vmap(lambda k: J.integrate_adaptive(
        "ees25", jt, jnp.ones(3), jvbt(k), JARGS, rtol=1e-2, max_steps=256,
        save_at=jnp.array(save_at), bounded=bounded))(keys)
    got = T.integrate_adaptive("ees25", tt, torch.ones(6, 3, dtype=torch.float64),
                               tvbt(_tkey(keys)), TARGS, rtol=1e-2,
                               max_steps=256, save_at=save_at, bounded=bounded)
    np.testing.assert_array_equal(_np(got.n_accepted), want.n_accepted)
    np.testing.assert_array_equal(_np(got.n_rejected), want.n_rejected)
    np.testing.assert_allclose(_np(got.y_final), want.y_final, rtol=0, atol=1e-8)
    # the port's save buffer is (n_saves, *batch, ...); the reference's is
    # per path (n_saves, ...)
    np.testing.assert_allclose(_np(got.ys).swapaxes(0, 1), want.ys, rtol=0,
                               atol=1e-8)
    assert torch.equal(got.ys[0], torch.ones(6, 3, dtype=torch.float64))


def test_sdeint_adaptive_matches_reference():
    """The sdeint wiring: one tree per path key, ys as (B, n_saves, ...)."""
    jt, tt = terms("ou")
    keys = jax.random.split(KEY, 4)
    ts = [0.0, 0.1, 0.25, 0.5, 0.9, 1.0]
    want = J.sdeint(jt, "ees25:adaptive", 0.0, 1.0, 256, jnp.ones(3), None,
                    args=JARGS, save_at=jnp.array(ts), rtol=1e-2, batch_keys=keys)
    got = T.sdeint(tt, "ees25:adaptive", 0.0, 1.0, 256,
                   torch.ones(3, dtype=torch.float64), None, args=TARGS,
                   save_at=ts, rtol=1e-2, batch_keys=_tkey(keys), device="cpu")
    assert isinstance(got, T.AdaptiveResult)
    assert got.ys.shape == (4, 6, 3) and got.y_final.shape == (4, 3)
    np.testing.assert_array_equal(_np(got.n_accepted), want.n_accepted)
    np.testing.assert_allclose(_np(got.ys), want.ys, rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(got.ys[:, -1]), _np(got.y_final), atol=1e-12)


def test_ode_gradient_matches_analytic():
    """d/da of e^{-a} through the adaptive loop (ODE mode, no driver)."""
    a = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    term = T.SDETerm(drift=lambda t, y, p: -p * y, noise="none")
    out = T.integrate_adaptive("ees25", term, torch.ones(1, dtype=torch.float64),
                               None, args=a, t0=0.0, t1=1.0, rtol=1e-5,
                               atol=1e-8, max_steps=1024)
    out.y_final[0].backward()
    np.testing.assert_allclose(float(a.grad), -np.exp(-1.0), rtol=1e-3)


def test_rejected_steps_do_not_perturb_the_path():
    """Different initial h (other reject patterns) land on the same pathwise
    solution: the tree keeps the path fixed under re-queries."""
    _, tt = terms("ou")
    tree = tvbt(_tkey(KEY)[None], tol=2.0 ** -14)
    outs = [T.integrate_adaptive("ees25", tt, torch.ones(1, 3, dtype=torch.float64),
                                 tree, TARGS, rtol=1e-4, atol=1e-6, h0=h0,
                                 max_steps=1024, bounded=False).y_final
            for h0 in (0.5, 0.01)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=2e-2)


def _sdeint(**kw):
    _, tt = terms("ou")
    return T.sdeint(tt, kw.pop("spec", "ees25:adaptive"), 0.0, 1.0, 64,
                    torch.ones(3, dtype=torch.float64), prng.PRNGKey(0, device="cpu"),
                    args=TARGS, device="cpu", **kw)


@pytest.mark.parametrize("kw,err,match", [
    (dict(spec="ees25", save_at=[0.5]), ValueError, "adaptive"),
    (dict(spec="ees25", rtol=1e-3), ValueError, "adaptive"),
    (dict(spec="ees25", atol=1e-5), ValueError, "adaptive"),
    (dict(spec="ees25", h0=0.1), ValueError, "adaptive"),
    (dict(spec="ees25", bm_tol=1e-3), ValueError, "adaptive"),
    (dict(adjoint="recursive", bounded=False), ValueError, "forward-only"),
    (dict(save_every=8), ValueError, "save_at"),
    (dict(spec="reversible_heun", adaptive=True), ValueError, "embedded"),
    (dict(save_at=[[0.5]]), ValueError, "1-D"),
], ids=["save_at", "rtol", "atol", "h0", "bm_tol", "unbounded", "save_every",
        "no-estimator", "save_at-2d"])
def test_option_errors(kw, err, match):
    with pytest.raises(err, match=match):
        _sdeint(**kw)


def test_direct_call_errors():
    _, tt = terms("ou")
    y0 = torch.ones(1, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="driver"):
        T.integrate_adaptive("ees25", tt, y0, None, TARGS)
    with pytest.raises(ValueError, match="t1 > t0"):
        T.realize_grid("ees25", tt, y0, tvbt(_tkey(KEY)[None]), TARGS, t0=1.0, t1=1.0)
    with pytest.raises(ValueError, match="single stage"):
        T.realize_grid("euler", tt, y0, tvbt(_tkey(KEY)[None]), TARGS)


# -- float32, against the reference without x64 ---------------------------------

_F32_SCRIPT = r"""
import json, sys
sys.path.insert(0, "tests")
import jax, jax.numpy as jnp, numpy as np, torch
assert not jax.config.jax_enable_x64
import repro.core as J, repro_torch.core as T
import test_torch_vbt_adaptive as M
jt, tt = M.terms("ou")
jargs = {k: jnp.float32(v) for k, v in M.TARGS.items()}
keys = jax.random.split(jax.random.PRNGKey(0), 16)
out = {}
for spec in ("ees25:adaptive", "ees27:adaptive"):
    want = J.sdeint(jt, spec, 0.0, 1.0, 256, jnp.ones(3), None, args=jargs,
                    batch_keys=keys, rtol=1e-2, save_at=jnp.array([0.5, 1.0]),
                    bounded=False)
    got = T.sdeint(tt, spec, 0.0, 1.0, 256, torch.ones(3), None, args=M.TARGS,
                   batch_keys=M._tkey(keys), rtol=1e-2, save_at=[0.5, 1.0],
                   bounded=False, device="cpu")
    out[spec] = dict(
        dtype=str(got.y_final.dtype),
        counts=bool((np.asarray(want.n_accepted) == got.n_accepted.numpy()).all()
                    and (np.asarray(want.n_rejected) == got.n_rejected.numpy()).all()),
        y=float(np.abs(np.asarray(want.y_final) - got.y_final.numpy()).max()),
        ys=float(np.abs(np.asarray(want.ys) - got.ys.numpy()).max()))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def float32_run():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", _F32_SCRIPT], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("spec", ["ees25:adaptive", "ees27:adaptive"])
def test_float32_matches_reference_without_x64(float32_run, spec):
    got = float32_run[spec]
    assert got["dtype"] == "torch.float32" and got["counts"]
    assert got["y"] < 1e-3 and got["ys"] < 1e-3, got


def test_tree_leaves_helper_is_flat():
    # the pytree-of-shapes tree returns one leaf per shape
    tree = tvbt(_tkey(KEY), shape=((2,), (3,)))
    assert [x.shape for x in tree_leaves(tree.weval(0.4))] == [(2,), (3,)]


def test_controller_statistics_gate_passes_between_one_ulp_moves():
    """chip_smoke.py phase 15(b) holds the card's controller against the
    CPU's on its statistics, in units of the card's spread against itself
    with h0 one ulp up.  On the CPU, float64, 256 paths of the Table-1
    model at rtol 1e-3: runs with h0 one ulp down and two ulp up, each held
    against the run at h0 by the spread of h0 one ulp up, stay within the
    gate's limits."""
    import importlib.util

    from repro_torch.nsde import init_lsde, lsde_term

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    params = init_lsde(0, 1, 16, 32, device="cpu").double()
    keys = T.path_keys(T.PRNGKey(31, device="cpu"), 256)
    h0 = 2.0 / 16
    runs = {}
    with torch.no_grad():
        for moved in (0, 1, -1, 2):
            h = h0
            for _ in range(abs(moved)):
                h = float(np.nextafter(h, np.inf if moved > 0 else 0.0))
            runs[moved] = T.sdeint(lsde_term(), "ees25:adaptive", 0.0, 2.0, 256,
                                   torch.zeros(16, dtype=torch.float64), None,
                                   args=params, rtol=1e-3, batch_keys=keys,
                                   bounded=False, h0=h, device="cpu")
    assert not torch.equal(runs[0].n_accepted, runs[1].n_accepted)
    for other in (-1, 2):
        z, ratio = smoke._controller_statistics(torch, runs[0], runs[other], runs[1])
        print(f"h0 moved {other} ulp: means within {z:.2f} sigma/sqrt(256), "
              f"spread {ratio:.2f} sigma")
        assert z <= smoke.MEAN_SIGMAS and ratio <= smoke.SPREAD_RATIO
