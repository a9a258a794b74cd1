"""The port's Table 7, Table 2 and stability-sweep benchmarks
(``repro_torch.benchmarks.{table7_gbm,table2_vol,bench_stability}``)
against the reference's (``benchmarks/``), on the same inputs.

* Table 7 at its full reference size (64 paths, D = 10, NFE 60), float32
  in a subprocess without x64 (the reference's default): ``terminal_max``
  per solver within rtol 1e-5 where finite (the float32 normals differ by
  erfinv ulps, and the unstable solvers amplify them), ``stable`` exactly,
  with the kernels' CPU twins on and off.
* Table 2 cut to batch 16 and NFE 72, the smallest budget whose four step
  counts (72, 36, 18, 24) each split into 6 saves, under the reversible and
  the recursive adjoint: the loss and every parameter's gradient against
  the reference's ``jax.value_and_grad`` of the same loss, weights carried
  over by ``lsde_params_from_jax``; float64 in this process at 1e-10
  relative to the largest entry (the adjoint tests' tolerance), float32 in
  the subprocess at 1e-4 (the float32 training tests' tolerance).
* The stability sweep reduced to three stiffnesses and budgets 32-256
  (float64): every run's stable flag and every frontier equal to the
  reference's on the same sweep, stable runs' mean squares within 1e-6
  (erfinv ulps, grown over the steps), the EES specs also through the
  kernels' twins, and the reference's bench gate passes.

The float32 subprocess starts with the module's first test and runs while
the float64 cases run here.
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

from repro_torch.benchmarks import bench_stability as sweep
from repro_torch.benchmarks import table2_vol as t2
from repro_torch.benchmarks import table7_gbm as t7
from repro_torch.core import PRNGKey
from repro_torch.nsde import lsde_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2_BATCH, T2_NFE = 16, 72
LABELS = ["RevHeun", "MCF-Euler", "MCF-Midpoint", "EES(2,5)"]
ADJOINTS = ["reversible", "recursive"]


def _ref_leaves(p):
    """The reference's LSDE params in the port's ``parameters()`` order."""
    layers = lambda name: [x for l in p[name] for x in (l["w"], l["b"])]  # noqa: E731
    return ([p["encoder"]["w"], p["encoder"]["b"]] + layers("drift")
            + layers("diff") + [p["readout"]["w"], p["readout"]["b"]])


def _ref_solvers():
    from repro.core import MCFSolver, ReversibleHeun, ees25_solver, euler, midpoint

    return dict(zip(LABELS, [ReversibleHeun(), MCFSolver(euler), MCFSolver(midpoint),
                             ees25_solver()]))


def ref_table7():
    """The reference's ``table7_gbm.run()`` without its timing: ``{label:
    terminal_max}`` (in the caller's precision: float32 without x64)."""
    from benchmarks import table7_gbm as j7
    from repro.core import SDETerm, brownian_path, solve

    A = jnp.asarray(j7.stiff_A(np.random.default_rng(1)), jnp.float32)
    term = SDETerm(drift=lambda t, y, a: y @ A.T,
                   diffusion=lambda t, y, a: j7.SIGMA * y, noise="diagonal")
    y0 = jnp.ones((64, j7.D))
    out = {}
    for (name, solver), (_, _, n) in zip(_ref_solvers().items(), t7.solvers()):
        bm = brownian_path(jax.random.PRNGKey(0), 0.0, j7.T, n, shape=(64, j7.D))
        r = jax.jit(lambda y: solve(solver, term, y, bm, None).y_final)(y0)
        out[name] = float(jnp.max(jnp.abs(r)))
    return out


def ref_table2(params, target, dtype, cases=None):
    """The reference's Table-2 loss at ``T2_BATCH`` paths and NFE ``T2_NFE``:
    ``{(label, adjoint): (loss, [grads in the port's parameter order])}``
    for ``cases`` (default: every solver under each of ``ADJOINTS``)."""
    from repro.core import brownian_path, solve
    from repro.nsde import lsde_readout, lsde_term, signature_mmd

    term = lsde_term()
    key = jax.random.PRNGKey(0)
    out = {}
    for (name, solver), (_, _, n) in zip(_ref_solvers().items(),
                                         t2.solvers(nfe=T2_NFE)):
        for adjoint in ADJOINTS:
            if cases is not None and (name, adjoint) not in cases:
                continue

            def loss(p, k, solver=solver, n=n, adjoint=adjoint):
                bm = brownian_path(k, 0.0, 1.0, n, shape=(T2_BATCH, 8), dtype=dtype)
                z0 = jnp.zeros((T2_BATCH, 8), dtype) + p["encoder"]["b"]
                r = solve(solver, term, z0, bm, p, adjoint=adjoint,
                          save_every=n // 6)
                ys = lsde_readout(p, r.ys)[..., 0].T
                return signature_mmd(1.0 + 0.1 * ys, target)

            v, g = jax.jit(jax.value_and_grad(loss))(params, key)
            out[name, adjoint] = (float(v), [np.asarray(x) for x in _ref_leaves(g)])
    return out


def port_table2(params, target, dtype, use_kernels=False, cases=None):
    """The port's Table-2 loss on the same weights, noise key and target."""
    tp = lsde_params_from_jax(params, dtype=dtype, device="cpu")
    tgt = torch.as_tensor(np.array(target), dtype=dtype)
    key = PRNGKey(0, device="cpu")
    out = {}
    for name, spec, n in t2.solvers(use_kernels, nfe=T2_NFE):
        for adjoint in ADJOINTS:
            if cases is not None and (name, adjoint) not in cases:
                continue
            loss = t2.make_loss(spec, n, tgt, batch=T2_BATCH, adjoint=adjoint)
            v, g = t2.value_and_grad(loss, tp, key)
            out[name, adjoint] = (float(v), [x.numpy() for x in g])
    return out


def table2_errors(got, want):
    """``{case: (loss rel err, max grad err relative to each leaf's max)}``.

    Two leaves have no gradient but rounding: the encoder weight is unused,
    and the MMD of time-augmented signatures sees increments only, so the
    readout bias drops out.  Their error is taken relative to the largest
    gradient entry."""
    out = {}
    for case, (wv, wg) in want.items():
        gv, gg = got[case]
        top = max(float(np.abs(w).max()) for w in wg)
        zero = (0, len(wg) - 1)  # encoder w, readout b
        gerr = max(float(np.abs(g - w).max())
                   / (top if i in zero else float(np.abs(w).max()))
                   for i, (g, w) in enumerate(zip(gg, wg)))
        out["/".join(case)] = (abs(gv - wv) / abs(wv), gerr)
    return out


def t2_inputs(dtype):
    from repro.nsde import init_lsde

    params = jax.tree_util.tree_map(lambda x: x.astype(dtype),
                                    init_lsde(jax.random.PRNGKey(0), 1, 8, width=16))
    return params, jnp.asarray(t2.target_paths(T2_BATCH), dtype)


_F32_SCRIPT = r"""
import json, sys
sys.path.insert(0, "tests")
import jax, jax.numpy as jnp, numpy as np, torch
assert not jax.config.jax_enable_x64
import test_torch_tables as T
t7 = T.ref_table7()
port7 = {str(k): {name: r.terminal_max for name, r in
                  ((n, T.t7.run_case(s, steps, device="cpu"))
                   for n, s, steps in T.t7.solvers(k))}
         for k in (False, True)}
params, target = T.t2_inputs(jnp.float32)
want = T.ref_table2(params, target, jnp.float32, T.F32_CASES)
got = T.port_table2(params, target, torch.float32, cases=T.F32_CASES)
print(json.dumps({"ref7": t7, "port7": port7, "t2": T.table2_errors(got, want)}))
"""


@pytest.fixture(scope="module", autouse=True)
def float32_proc():
    """The float32 subprocess, started with the module's first test."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.Popen([sys.executable, "-c", _F32_SCRIPT], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def float32_run(float32_proc):
    out, err = float32_proc.communicate(timeout=600)
    assert float32_proc.returncode == 0, out + err
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def table2_float64():
    params, target = t2_inputs(jnp.float64)
    return (ref_table2(params, target, jnp.float64),
            {k: port_table2(params, target, torch.float64, k) for k in (False, True)})


@pytest.mark.parametrize("use_kernels", [False, True])
def test_table2_matches_reference_float64(table2_float64, use_kernels):
    want, got = table2_float64[0], table2_float64[1][use_kernels]
    for case, (loss_err, grad_err) in table2_errors(got, want).items():
        assert loss_err < 1e-10 and grad_err < 1e-10, case


def test_table2_recursive_equals_reversible_loss(table2_float64):
    """Both adjoints run the same forward: one loss per solver, bitwise; the
    recursive gradients are the discrete computation's, the reversible ones
    its reconstruction's, so they agree to EES's O(h^{m+1}) reconstruction
    error (1e-6, as the port's reversible-vs-full test)."""
    got = table2_float64[1][False]
    for name in LABELS:
        (lr, gr), (lv, gv) = got[name, "recursive"], got[name, "reversible"]
        assert lr == lv
        for a, b in zip(gr, gv):
            if np.abs(b).max() > 0:
                assert np.abs(a - b).max() / np.abs(b).max() < 1e-6


# -- the stability sweep -----------------------------------------------------

STIFF, BUDGETS = (2.0, 16.0, 64.0), (32, 64, 128, 256)


@pytest.fixture(scope="module")
def ref_sweep():
    """The reference's mean squares on the reduced sweep: one compiled solve
    per (solver, steps), the stiffness passed as its argument."""
    from benchmarks import bench_stability as jbs
    from repro.core import sdeint

    term = jbs.linear_term()
    y0 = jnp.ones(jbs.DIM, jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), jbs.N_PATHS)
    out = {}
    for spec in jbs.SOLVERS:
        eps = jbs.evals_per_step(spec)
        for budget in BUDGETS:
            n = max(1, round(budget / eps))
            f = jax.jit(jax.vmap(lambda k, a, spec=spec, n=n: sdeint(
                term, spec, 0.0, jbs.T1, n, y0, k, args=a).y_final, in_axes=(0, None)))
            for lam in STIFF:
                out[spec, lam, budget] = (n, float(jnp.mean(f(keys, jnp.float64(lam)) ** 2)))
    return out


def test_sweep_frontiers_equal_reference(ref_sweep):
    from benchmarks import bench_stability as jbs

    specs = list(sweep.SOLVERS) + ["ees25:use_kernels=True", "ees27:use_kernels=True"]
    payload = sweep.run(device="cpu", solvers=specs, stiffness=STIFF, budgets=BUDGETS,
                        verbose=False)
    assert tuple(sweep.SOLVERS) == jbs.SOLVERS and sweep.BUDGETS == jbs.BUDGETS
    assert sweep.STIFFNESS == jbs.STIFFNESS
    want_fr = {}
    for r in payload["records"]:
        n, ms = ref_sweep[r["solver"].split(":")[0], r["stiffness"], r["budget"]]
        stable = bool(np.isfinite(ms) and ms <= jbs.MS_THRESHOLD)
        assert (r["n_steps"], r["stable"]) == (n, stable), r
        if stable:
            np.testing.assert_allclose(r["ms_final"], ms, rtol=1e-6)
        fr = want_fr.setdefault(r["solver"], {}).setdefault(
            f"{r['stiffness']:g}", {"max_stable_h": 0.0, "min_stable_budget": None})
        if stable:
            fr["max_stable_h"] = max(fr["max_stable_h"], r["h"])
            if fr["min_stable_budget"] is None:
                fr["min_stable_budget"] = r["budget"]
    assert payload["frontiers"] == want_fr
    for k in ("ees25", "ees27"):
        assert payload["frontiers"][k + ":use_kernels=True"] == payload["frontiers"][k]
    assert sweep.gate(payload) == []
    # Theorem 2.1: Reversible Heun has no stable step at the stiff end
    assert payload["frontiers"]["reversible-heun"]["64"]["max_stable_h"] == 0.0


def test_sweep_gate_is_the_references():
    """``gate`` passes the reference's committed sweep and fails a frontier
    where Reversible Heun beats EES(2,5)."""
    with open(os.path.join(REPO, "BENCH_stability.json")) as f:
        payload = json.load(f)
    assert sweep.gate(payload) == []
    payload["frontiers"]["reversible-heun"]["2"]["max_stable_h"] = 1.0
    assert len(sweep.gate(payload)) == 1


def test_sweep_cli_refuses_a_bench_name(tmp_path):
    with pytest.raises(SystemExit, match="BENCH_"):
        sweep.main(["--device", "cpu", "--out", str(tmp_path / "BENCH_stability.json")])


# -- float32: Table 7 and Table 2 (the subprocess) ------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
def test_table7_matches_reference(float32_run, use_kernels):
    ref, port = float32_run["ref7"], float32_run["port7"][str(use_kernels)]
    assert list(port) == LABELS
    for name in LABELS:
        want, got = ref[name], port[name]
        assert np.isfinite(got) == np.isfinite(want), name
        if np.isfinite(want):
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        assert (np.isfinite(got) and got < 10.0) == (np.isfinite(want) and want < 10.0)
    # the reference's outcome: EES(2,5) stable, Reversible Heun not
    assert port["EES(2,5)"] < 10.0 and not port["RevHeun"] < 10.0


def test_table7_run_reports_rows():
    rows = t7.run(device="cpu", use_kernels=True)
    assert [r.stable for r in rows.values()] == [False, False, False, True]
    assert all(r.y_final.shape == (64, 10) and r.seconds > 0 for r in rows.values())


# float32: every solver under the reference's reversible adjoint, and
# EES(2,5) under the recursive one (float64 below holds all eight).
F32_CASES = [(n, "reversible") for n in LABELS] + [("EES(2,5)", "recursive")]


@pytest.mark.parametrize("case", ["/".join(c) for c in F32_CASES])
def test_table2_matches_reference_float32(float32_run, case):
    loss_err, grad_err = float32_run["t2"][case]
    assert loss_err < 1e-4 and grad_err < 1e-4
