"""The paper's manifold experiments in the port against the reference:
Tables 3 and 4 (``benchmarks/table{3_kuramoto,4_sphere}.py``), their
memory curves (Figs 5b and 6) and the convergence rates of Figs 7 and 8
(``benchmarks/fig_convergence.py``).

* One epoch of each case — the loss and every gradient leaf — against the
  reference's ``jax.value_and_grad`` of the same loss on carried
  parameters: in float64 in-process at a cut size, one dtype throughout
  (the reference's loss rebuilt with float64 draws; its own benchmark draws
  float32 noise whatever the state's dtype), within 1e-10 of each leaf's
  largest entry; and in float32 at the benchmarks' full sizes in a
  subprocess without x64, through the reference benchmarks' own
  ``make_loss``, within 1e-4.
* The memory ordering of Figs 5b and 6 from ``LiveBytes`` on the CPU, with
  per-step increments: the reversible adjoint's peak flat (its growth under
  a tenth of the full adjoint's), the full adjoint's growing with the steps,
  the recursive one's below it.
* ``fig_convergence``'s per-level errors within 1e-9 relative of the
  reference's (float64; the reference's solver steps driven by a jitted
  scan, the same recurrences as its benchmark's eager loop), the
  backward-recovery errors also within 1e-14 absolute (they are
  differences of O(1) states, so they carry those states' rounding, ~1e-16,
  however small they are), and the fitted slopes within 1e-6 forward and
  1e-4 backward (the benchmark prints them to two decimals; the smallest
  recovery error, ~5e-10, carries ~5e-6 relative rounding).
* The suite entry point runs the seven modules in the reference's order,
  passes ``--device`` on and reports a module that raises as an ERROR row.
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
import repro.nsde as JN
from repro_torch.benchmarks import fig_convergence as tfc
from repro_torch.benchmarks import table3_kuramoto as tt3
from repro_torch.benchmarks import table4_sphere as tt4
from repro_torch.benchmarks.common import value_and_grad
from repro_torch.core import prng
from repro_torch.nsde import fbm_increments, kuramoto_params_from_jax, sphere_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OSC, BATCH3 = 5, 3          # Table 3 cut: 5 oscillators, 3 targets (4 samples each)
BATCH4 = 6                    # Table 4 cut: 6 trajectories on S^7
T3_CASES = (("cg2", "full", 6), ("cg2", "recursive", 6), ("cfees25", "reversible", 4))
T4_CASES = (("geo-em", "full", 6), ("cfees25", "reversible", 3))


def _leaf_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


# ---------------------------------------------------------------------------
# Table 3, float64.
# ---------------------------------------------------------------------------

def _ref_t3_loss(spec, adjoint, n_steps, tgt_th, tgt_om):
    """The reference's Table-3 loss with float64 draws."""
    term, solver = JN.kuramoto_nsde_term(), J.get_solver(spec)

    def loss(p, k, th0, om0):
        def one(key):
            bm = J.brownian_path(key, 0.0, 2.0, n_steps, shape=(th0.shape, th0.shape),
                                 dtype=jnp.float64)
            return J.solve(solver, term, (th0, om0), bm, p, adjoint=adjoint).y_final

        ths, oms = jax.vmap(one)(jax.random.split(k, 4))
        es = jax.vmap(lambda i: JN.wrapped_energy_score(
            ths[:, i], oms[:, i], tgt_th[i], tgt_om[i]))(jnp.arange(th0.shape[0]))
        return jnp.mean(es)

    return loss


def _kuramoto_grad_leaves(g):
    return [g[name][i][w] for name in ("drift", "diff")
            for i in range(len(g[name])) for w in ("w", "b")]


@pytest.fixture(scope="module")
def t3_inputs():
    from repro.nsde import data as jdata

    ths, oms = jdata.kuramoto_paths(np.random.default_rng(3), N_OSC, BATCH3, 40, T=2.0,
                                    subsample=40)
    arrays = (ths[:, 0], oms[:, 0], ths[:, -1], oms[:, -1])
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                JN.init_kuramoto_nsde(jax.random.PRNGKey(0), N_OSC, width=8))
    return arrays, jp


@pytest.mark.parametrize("spec,adjoint,n_steps", T3_CASES)
def test_table3_epoch_matches_reference_float64(t3_inputs, spec, adjoint, n_steps):
    arrays, jp = t3_inputs
    jloss = _ref_t3_loss(spec, adjoint, n_steps, *map(jnp.asarray, arrays[2:]))
    jv, jg = jax.value_and_grad(jloss)(jp, jax.random.PRNGKey(11),
                                       *map(jnp.asarray, arrays[:2]))
    th0, om0, tth, tom = (torch.tensor(a) for a in arrays)
    tp = kuramoto_params_from_jax(jp, device="cpu")
    tloss = tt3.make_loss(spec, adjoint, n_steps, tth, tom)
    tv, tg = value_and_grad(tloss, tp, prng.PRNGKey(11, device="cpu"), th0, om0)
    assert abs(float(tv) - float(jv)) <= 1e-10 * abs(float(jv))
    for g, w in zip(tg, _kuramoto_grad_leaves(jg)):
        assert _leaf_err(g, w) < 1e-10


# ---------------------------------------------------------------------------
# Table 4, float64.
# ---------------------------------------------------------------------------

def _ref_t4_loss(spec, adjoint, n_steps):
    term, solver = JN.sphere_nsde_term(8), J.get_solver(spec)

    def loss(p, k, y0, labels):
        bm = J.brownian_path(k, 0.0, 1.0, n_steps, shape=(y0.shape[0], 28), dtype=jnp.float64)
        r = J.solve(solver, term, y0, bm, p["sde"], adjoint=adjoint)
        logp = jax.nn.log_softmax(r.y_final @ p["head"])
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))

    return loss


@pytest.fixture(scope="module")
def t4_inputs():
    rng = np.random.default_rng(4)
    y0 = rng.normal(size=(BATCH4, 8))
    y0 /= np.linalg.norm(y0, axis=-1, keepdims=True)
    labels = rng.integers(0, 4, size=BATCH4)
    k1 = jax.random.split(jax.random.PRNGKey(0))[0]
    jp = {"sde": JN.init_sphere_nsde(k1, 8, width=8),
          "head": 0.1 * jax.random.normal(k1, (8, 4))}
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jp)
    jp["sde"]["log_sigma"] = jnp.float64(0.4)
    return y0, labels, jp


def _port_t4_params(jp):
    return tt4.SphereClassifier(sphere_params_from_jax(jp["sde"], device="cpu"),
                                torch.tensor(np.asarray(jp["head"])))


def _sphere_grads_by_name(g):
    """The reference's gradient leaves under the port's parameter names."""
    out = {f"sde.drift.layers.{i}.{w}": g["sde"]["drift"][i][w]
           for i in range(len(g["sde"]["drift"])) for w in ("w", "b")}
    out.update({"sde.log_sigma": g["sde"]["log_sigma"], "head": g["head"]})
    return out


@pytest.mark.parametrize("spec,adjoint,n_steps", T4_CASES)
def test_table4_epoch_matches_reference_float64(t4_inputs, spec, adjoint, n_steps):
    y0, labels, jp = t4_inputs
    jv, jg = jax.value_and_grad(_ref_t4_loss(spec, adjoint, n_steps))(
        jp, jax.random.PRNGKey(12), jnp.asarray(y0), jnp.asarray(labels))
    tp = _port_t4_params(jp)
    tv, tg = value_and_grad(tt4.make_loss(spec, adjoint, n_steps), tp,
                            prng.PRNGKey(12, device="cpu"), torch.tensor(y0),
                            torch.tensor(labels))
    assert abs(float(tv) - float(jv)) <= 1e-10 * abs(float(jv))
    want = _sphere_grads_by_name(jg)
    for (name, _), g in zip(tp.named_parameters(), tg):
        assert _leaf_err(g, want[name]) < 1e-10, name


def test_table4_accuracy_counts_the_heads_hits(t4_inputs):
    y0, labels, jp = t4_inputs
    tp = _port_t4_params(jp)
    acc = tt4.accuracy(tp, "cfees25", 3, prng.PRNGKey(2, device="cpu"), torch.tensor(y0),
                       torch.tensor(labels))
    bm = J.brownian_path(jax.random.PRNGKey(2), 0.0, 1.0, 3, shape=(BATCH4, 28),
                         dtype=jnp.float64)
    yf = J.solve(J.cfees25_solver(), JN.sphere_nsde_term(8), jnp.asarray(y0), bm,
                 jp["sde"]).y_final
    hits = int(jnp.sum((yf @ jp["head"]).argmax(-1) == jnp.asarray(labels)))
    assert float(acc) == hits / BATCH4


# ---------------------------------------------------------------------------
# Float32 at the benchmarks' sizes, through the reference benchmarks' losses.
# ---------------------------------------------------------------------------

_F32_SCRIPT = r"""
import json
import jax, jax.numpy as jnp, numpy as np, torch
assert not jax.config.jax_enable_x64
from benchmarks import table3_kuramoto as j3, table4_sphere as j4
from repro_torch.benchmarks import table3_kuramoto as t3, table4_sphere as t4
from repro_torch.benchmarks.common import value_and_grad
from repro_torch.core import prng
from repro_torch.nsde import kuramoto_params_from_jax, sphere_params_from_jax

def errs(tv, tg, jv, jleaves):
    out = [abs(float(tv) - float(jv)) / abs(float(jv))]
    for g, w in zip(tg, jleaves):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        out.append(float(np.abs(g.numpy() - w).max() / max(1e-30, np.abs(w).max())))
    return max(out)

out = {}
rng = np.random.default_rng(3)
ths, oms = j3.kuramoto_paths(rng, j3.N, j3.BATCH, 400, T=j3.T, subsample=400)
jdata = [jnp.asarray(a, jnp.float32) for a in (ths[:, 0], oms[:, 0], ths[:, -1], oms[:, -1])]
tdata = t3.data(device="cpu")
out["t3_data"] = bool(all(np.array_equal(t.numpy(), np.asarray(j)) for t, j in zip(tdata, jdata)))
jp = j3.init_kuramoto_nsde(jax.random.PRNGKey(0), j3.N, width=64)
tp = kuramoto_params_from_jax(jp, device="cpu")
key = jax.random.PRNGKey(5)
for name, spec, adjoint, steps in t3.cases():
    solver = {"cg2": j3.CrouchGrossman2(), "cfees25": j3.cfees25_solver()}[spec]
    jv, jg = jax.value_and_grad(j3.make_loss(solver, adjoint, steps, jdata[2], jdata[3]))(
        jp, key, jdata[0], jdata[1])
    tv, tg = value_and_grad(t3.make_loss(spec, adjoint, steps, tdata[2], tdata[3]), tp,
                            prng.PRNGKey(5, device="cpu"), tdata[0], tdata[1])
    leaves = [jg[n][i][w] for n in ("drift", "diff") for i in range(len(jg[n]))
              for w in ("w", "b")]
    out["t3/" + name] = errs(tv, tg, jv, leaves)

key = jax.random.PRNGKey(0)
y0, labels = j4.data(key)
k1, _ = jax.random.split(key)
jp = {"sde": j4.init_sphere_nsde(k1, 8, width=32), "head": 0.1 * jax.random.normal(k1, (8, 4))}
tp = t4.SphereClassifier(sphere_params_from_jax(jp["sde"], device="cpu"),
                         torch.tensor(np.asarray(jp["head"])))
ty0, tlab = torch.tensor(np.asarray(y0)), torch.tensor(np.asarray(labels)).long()
for name, spec, adjoint, steps in t4.cases():
    solver = {"geo-em": j4.GeoEulerMaruyama(), "cfees25": j4.cfees25_solver()}[spec]
    jv, jg = jax.value_and_grad(j4.make_loss(solver, adjoint, steps))(jp, key, y0, labels)
    tv, tg = value_and_grad(t4.make_loss(spec, adjoint, steps), tp,
                            prng.PRNGKey(0, device="cpu"), ty0, tlab)
    by_name = {f"sde.drift.layers.{i}.{w}": jg["sde"]["drift"][i][w]
               for i in range(3) for w in ("w", "b")}
    by_name.update({"sde.log_sigma": jg["sde"]["log_sigma"], "head": jg["head"]})
    out["t4/" + name] = errs(tv, tg, jv, [by_name[n] for n, _ in tp.named_parameters()])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def float32_tables():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + REPO,
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", _F32_SCRIPT], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_table3_data_are_the_reference_data(float32_tables):
    assert float32_tables["t3_data"]


@pytest.mark.parametrize("case", [f"t3/{name}" for name, *_ in tt3.cases()]
                         + [f"t4/{name}" for name, *_ in tt4.cases()])
def test_tables_epoch_match_reference_float32(float32_tables, case):
    assert float32_tables[case] < 1e-4


# ---------------------------------------------------------------------------
# Figs 5b and 6: the memory ordering, counted on the CPU.
# ---------------------------------------------------------------------------

MEM_STEPS = (8, 64)


def _gates(series):
    rev, full = series["reversible"], series["full"]
    assert rev[-1] - rev[0] < 0.1 * (full[-1] - full[0]), series
    assert full[-1] >= 4 * full[0], series
    if "recursive" in series:
        assert series["recursive"][-1] < full[-1], series


def test_fig5b_memory_ordering_on_the_cpu(t3_inputs):
    arrays, jp = t3_inputs
    inputs = tuple(torch.tensor(a, dtype=torch.float32) for a in arrays)
    params = kuramoto_params_from_jax(jp, dtype=torch.float32, device="cpu")
    _gates(tt3.memory_series(params, prng.PRNGKey(1, device="cpu"), inputs,
                             steps=MEM_STEPS, bulk_increments=False))


def test_fig6_memory_ordering_on_the_cpu(t4_inputs):
    y0, labels, _ = t4_inputs
    params = tt4.init_params(prng.PRNGKey(0, device="cpu"))
    _gates(tt4.memory_series(params, prng.PRNGKey(1, device="cpu"),
                             torch.tensor(y0, dtype=torch.float32), torch.tensor(labels),
                             steps=MEM_STEPS, bulk_increments=False))


# ---------------------------------------------------------------------------
# Figs 7 and 8: the convergence rates.
# ---------------------------------------------------------------------------

def _ref_driver(solver, term):
    step = lambda y, inc: (solver.step(term, y, 0.0, 0.0, inc, None), None)  # noqa: E731
    back = lambda y, inc: (solver.reverse(term, y, 0.0, 0.0, inc, None), None)  # noqa: E731

    @jax.jit
    def drive(y0, incs):
        y, _ = jax.lax.scan(step, y0, incs)
        yb, _ = jax.lax.scan(back, y, incs, reverse=True)
        return y, yb

    return drive


def _ref_euclidean(H, solver):
    term = J.SDETerm(drift=lambda t, y, a: jnp.zeros_like(y),
                     diffusion=lambda t, y, a: jnp.stack([jnp.cos(y), jnp.sin(y)], -1),
                     noise="general")
    drive = _ref_driver(solver, term)
    rng = np.random.default_rng(5)
    ns = [32, 64, 128, 256]
    errs, rerrs = {n: [] for n in ns}, {n: [] for n in ns}
    y0 = jnp.asarray([1.0])
    for _ in range(3):
        fine = np.stack([fbm_increments(rng, 1024, H, 1.0)[0] for _ in range(2)], -1)
        ref, _ = drive(y0, jnp.asarray(fine))
        for n in ns:
            y, yb = drive(y0, jnp.asarray(fine.reshape(n, 1024 // n, 2).sum(1)))
            errs[n].append(float(jnp.abs(y - ref)[0]))
            rerrs[n].append(float(jnp.abs(yb - y0)[0]))
    return [np.mean(errs[n]) for n in ns], [np.mean(rerrs[n]) for n in ns], ns


def _ref_so3(H):
    def xi(t, y, a):
        g1 = jnp.stack([0.1 + 0.3 * y[..., 2, 0], -(0.25 + 0.2 * y[..., 1, 2]),
                        0.9 + 0.2 * y[..., 0, 0]], -1)
        g2 = jnp.stack([0.8 + 0.15 * y[..., 2, 2], 0.15 + 0.25 * y[..., 0, 1],
                        0.35 - 0.2 * y[..., 1, 1]], -1)
        return jnp.stack([g1, g2], -1)

    term = J.ManifoldSDETerm(group=J.SO3(), drift=lambda t, y, a: jnp.zeros((3,)),
                             diffusion=xi, noise="general",
                             noise_apply=lambda g, dw: jnp.einsum("...ij,...j->...i", g, dw))
    drive = _ref_driver(J.cfees25_solver(), term)
    rng = np.random.default_rng(7)
    ns = [32, 64, 128]
    fine = np.stack([fbm_increments(rng, 512, H, 1.0)[0] for _ in range(2)], -1)
    y0 = jnp.eye(3)
    ref, _ = drive(y0, jnp.asarray(fine))
    errs, rerrs = [], []
    for n in ns:
        y, yb = drive(y0, jnp.asarray(fine.reshape(n, 512 // n, 2).sum(1)))
        errs.append(float(jnp.max(jnp.abs(y - ref))))
        rerrs.append(float(jnp.max(jnp.abs(yb - y0))))
    return errs, rerrs, ns


RATE_CASES = ["EES25/H=0.5", "EES25/H=0.6", "EES27/H=0.5", "CF-EES25-SO3/H=0.5"]


@pytest.mark.parametrize("case", RATE_CASES)
def test_fig_convergence_errors_match_reference(case):
    name, h = case.split("/H=")
    H = float(h)
    if name == "CF-EES25-SO3":
        got = tfc.so3_rates(H, device="cpu")
        errs, rerrs, ns = _ref_so3(H)
    else:
        solvers = {"EES25": (tfc.ees25_solver, J.ees25_solver),
                   "EES27": (tfc.ees27_solver, J.ees27_solver)}[name]
        got = tfc.euclidean_rates(H, solvers[0](), name, device="cpu")
        errs, rerrs, ns = _ref_euclidean(H, solvers[1]())
    np.testing.assert_allclose(got.errs, errs, rtol=1e-9)
    # A recovery error is a difference of O(1) states: it carries their
    # rounding (~1e-16 absolute) whatever its own size.
    np.testing.assert_allclose(got.rerrs, rerrs, rtol=1e-9, atol=1e-14)
    log_n = np.log([1.0 / n for n in ns])
    fwd = np.polyfit(log_n, np.log(np.asarray(errs) + 1e-16), 1)[0]
    bwd = np.polyfit(log_n, np.log(np.asarray(rerrs) + 1e-16), 1)[0]
    assert abs(got.fwd - fwd) < 1e-6 and abs(got.bwd - bwd) < 1e-4
    if name == "CF-EES25-SO3":
        assert float(J.SO3().distance_from_manifold(jnp.asarray(got.y_ref.numpy()))) < 1e-12


# ---------------------------------------------------------------------------
# The suite entry point.
# ---------------------------------------------------------------------------

def test_suite_runs_the_seven_modules_in_the_reference_order(monkeypatch, capsys):
    import importlib

    from repro_torch.benchmarks import run as suite

    order = ["table7_gbm", "table1_ou", "table2_vol", "table3_kuramoto",
             "table4_sphere", "fig_convergence", "bench_throughput"]
    calls = []
    for name in order:
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")

        def fake(argv=None, name=name):
            calls.append((name, argv))
            if name == "table2_vol":
                raise RuntimeError("boom")

        monkeypatch.setattr(mod, "main", fake)
    suite.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [c[0] for c in calls] == order
    assert all(argv == ["--device", "cpu"] for _, argv in calls)
    assert "table2_vol,nan,ERROR" in out and "# total" in out
