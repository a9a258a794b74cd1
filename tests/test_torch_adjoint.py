"""The reversible and recursive adjoints of the port against the reference's,
and against the port's own full adjoint.

Float64, in this process, on the neural Langevin SDE at a small size
(``d_z=4``, ``width=8``, 16 paths, 8 steps), with ``save_every`` and the
guard.  Tolerances, and why:

* port reversible vs reference reversible, gradients with respect to ``y0``
  and every parameter: 1e-10 relative to the largest entry (measured:
  ~2e-15 on these inputs).  The two sweeps
  run the same reconstruction and replay; they differ by the float64
  normals (torch's and XLA's erfinv differ by ulps, ~1e-11 relative), by the
  order in which the batched replay sums per-path parameter gradients (the
  reference sums per-path VJPs in its vmap transpose) and by XLA's FMA
  contraction;
* port reversible vs port full: the reference's own tolerances
  (``tests/test_solvers_adjoint.py``) — 1e-6 relative for EES, whose
  reconstruction is approximate (O(h^{m+1}) per step), 1e-9 for Reversible
  Heun and MCF, whose inverse is algebraic;
* port recursive vs reference recursive: 1e-10 relative to the largest
  entry, the reversible comparison's tolerance and for the same reasons;
* port recursive vs port full: bitwise (the reference's own test asks 1e-10,
  ``tests/test_solvers_adjoint.py``): the checkpointed chunks replay the
  same operations, and the backward walks the same graph;
* within the port, bitwise: the kernel route (CPU twins) equals the plain
  route, bulk increments equal per-step draws, guarded equals unguarded, a
  padded grid equals the exact grid of its live steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sdeint as jsdeint
from repro.core.sdeint import path_keys as jpath_keys
from repro.nsde import init_lsde as jinit, lsde_term as jterm
from repro_torch.core import PRNGKey, get_solver, path_keys, sdeint, sdeint_ticks, solve
from repro_torch.nsde import lsde_params_from_jax, lsde_term

D_Z, WIDTH, N_PATHS, N_STEPS = 4, 8, 16, 8
SPECS = ["ees25", "ees27", "reversible_heun", "mcf-euler", "mcf-midpoint"]
ALGEBRAIC = ("reversible_heun", "mcf-euler", "mcf-midpoint")


def ref_leaves(p):
    """The reference's LSDE params in the port's ``parameters()`` order."""
    layers = lambda name: [x for l in p[name] for x in (l["w"], l["b"])]  # noqa: E731
    return ([p["encoder"]["w"], p["encoder"]["b"]] + layers("drift")
            + layers("diff") + [p["readout"]["w"], p["readout"]["b"]])


@pytest.fixture(scope="module")
def model():
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64), jinit(jax.random.PRNGKey(2), 1, D_Z, WIDTH))
    y0 = jnp.linspace(-0.5, 0.5, D_Z)
    rng = np.random.default_rng(0)
    weights = (rng.normal(size=(N_PATHS, D_Z)), rng.normal(size=(N_PATHS, 2, D_Z)))
    return params, y0, weights


def _loss(yf, ys, weights, lib):
    wf, ws = weights
    return (lib.sum(yf * wf) + lib.sum(ys ** 2 * ws)) if lib is jnp else \
        (yf * torch.from_numpy(wf)).sum() + (ys ** 2 * torch.from_numpy(ws)).sum()


_REF_GRADS = {}


def _ref_grads(model, spec, adjoint="reversible"):
    """The reference's gradients, computed once per (spec, adjoint)."""
    if (spec, adjoint) not in _REF_GRADS:
        _REF_GRADS[spec, adjoint] = _compute_ref_grads(model, spec, adjoint)
    return _REF_GRADS[spec, adjoint]


def _compute_ref_grads(model, spec, adjoint):
    params, y0, weights = model
    jk = jpath_keys(jax.random.PRNGKey(5), N_PATHS)

    def loss(p, y):
        r = jsdeint(jterm(), spec, 0.0, 1.0, N_STEPS, y, None, args=p,
                    batch_keys=jk, save_every=4, guard=1e6, adjoint=adjoint)
        return _loss(r.y_final, r.ys, weights, jnp)

    gp, gy = jax.grad(loss, argnums=(0, 1))(params, y0)
    return [np.asarray(x) for x in ref_leaves(gp)], np.asarray(gy)


def _port_grads(model, spec, adjoint="reversible", **kw):
    params, y0, weights = model
    tp = lsde_params_from_jax(params, device="cpu")
    ty0 = torch.from_numpy(np.array(y0)).requires_grad_()
    keys = path_keys(PRNGKey(5, device="cpu"), N_PATHS)
    kw.setdefault("guard", 1e6)
    r = sdeint(lsde_term(), spec, 0.0, 1.0, N_STEPS, ty0, args=tp, batch_keys=keys,
               save_every=4, adjoint=adjoint, device="cpu", **kw)
    leaves = list(tp.parameters())
    grads = torch.autograd.grad(_loss(r.y_final, r.ys, weights, torch),
                                leaves + [ty0], allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves + [ty0], grads)]
    return [g.numpy() for g in grads[:-1]], grads[-1].numpy(), r


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_reversible_grads_match_reference(model, spec, use_kernels):
    want_p, want_y = _ref_grads(model, spec)
    full = spec + (":use_kernels=True" if use_kernels else "")
    got_p, got_y, r = _port_grads(model, full)
    assert not r.diverged.any() and r.diverged.shape == (N_PATHS,)
    assert _rel(got_y, want_y) < 1e-10
    for g, w in zip(got_p, want_p):
        if np.abs(w).max() == 0:  # the readout and encoder weight: unused
            assert np.abs(g).max() == 0
        else:
            assert _rel(g, w) < 1e-10


@pytest.mark.parametrize("spec", SPECS)
def test_reversible_close_to_full(model, spec):
    rev_p, rev_y, _ = _port_grads(model, spec)
    full_p, full_y, _ = _port_grads(model, spec, adjoint="full")
    tol = 1e-9 if spec in ALGEBRAIC else 1e-6
    assert _rel(rev_y, full_y) < tol
    for g, w in zip(rev_p, full_p):
        if np.abs(w).max() > 0:
            assert _rel(g, w) < tol


@pytest.mark.parametrize("spec", ["ees25", "mcf-midpoint", "reversible_heun"])
def test_reversible_routes_bitwise(model, spec):
    """Kernel route, per-step increments and the guard change no bit of the
    reversible gradients."""
    base_p, base_y, base = _port_grads(model, spec)
    for kw, s in ((dict(), spec + ":use_kernels=True"),
                  (dict(bulk_increments=False), spec),
                  (dict(guard=None), spec)):
        got_p, got_y, r = _port_grads(model, s, **kw)
        assert torch.equal(r.y_final, base.y_final) and torch.equal(r.ys, base.ys)
        assert np.array_equal(got_y, base_y)
        for g, w in zip(got_p, base_p):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("spec", ["ees27", "reversible_heun"])
def test_reversible_on_padded_grid_equals_exact(model, spec):
    """Padding steps are skipped backward as forward: the gradients of a
    padded grid's live prefix equal the exact grid's, bitwise."""
    params, y0, _ = model
    tp = lsde_params_from_jax(params, device="cpu")
    keys = path_keys(PRNGKey(8, device="cpu"), N_PATHS)
    h, active = 0.125, 5

    def grads(run):
        leaves = list(tp.parameters())
        y = torch.from_numpy(np.array(y0)).requires_grad_()
        yf = run(y)
        return torch.autograd.grad((yf ** 2).sum(), leaves + [y], allow_unused=True)

    padded = grads(lambda y: sdeint_ticks(
        lsde_term(), spec, 0.0, 1.0, 8, y, keys[None], args=tp, active_steps=[active],
        step_size=h, adjoint="reversible", device="cpu").y_final[0])
    exact = grads(lambda y: sdeint(
        lsde_term(), spec, 0.0, active * h, active, y, args=tp, batch_keys=keys,
        adjoint="reversible", device="cpu").y_final)
    for a, b in zip(padded, exact):
        assert (a is None and b is None) or torch.equal(a, b)


def test_reversible_memory_holds_no_trajectory(model):
    """The forward keeps the final state and the bulk increments only: the
    autograd graph of a reversible solve has one node for the whole loop."""
    params, y0, _ = model
    tp = lsde_params_from_jax(params, device="cpu")
    y = torch.from_numpy(np.array(y0)).requires_grad_()
    r = sdeint(lsde_term(), "ees25", 0.0, 1.0, 64, y, args=tp, adjoint="reversible",
               batch_keys=path_keys(PRNGKey(1, device="cpu"), 4), device="cpu")
    node = r.y_final.grad_fn
    assert type(node).__name__ == "_ReversibleBackward"
    saved = node.saved_tensors
    assert len(saved) == 1 and saved[0].shape == (4, D_Z)


def test_solve_reversible_without_grad_is_the_forward(model):
    params, y0, _ = model
    tp = lsde_params_from_jax(params, device="cpu")
    keys = path_keys(PRNGKey(3, device="cpu"), 4)
    with torch.no_grad():
        rev = sdeint(lsde_term(), "ees25", 0.0, 1.0, 8, torch.from_numpy(np.array(y0)),
                     args=tp, batch_keys=keys, adjoint="reversible", save_every=2,
                     device="cpu")
        full = sdeint(lsde_term(), "ees25", 0.0, 1.0, 8, torch.from_numpy(np.array(y0)),
                      args=tp, batch_keys=keys, save_every=2, device="cpu")
    assert torch.equal(rev.y_final, full.y_final) and torch.equal(rev.ys, full.ys)


def test_reversible_grads_of_a_tensor_args_pytree():
    """args need not be a module: grad-requiring tensors of a pytree get
    their cotangents too."""
    from repro_torch.core import SDETerm, TimeGrid
    from repro_torch.core.brownian import brownian_path

    a = torch.tensor([0.7, -0.3], dtype=torch.float64, requires_grad=True)
    term = SDETerm(drift=lambda t, y, p: p["a"] * torch.sin(y),
                   diffusion=lambda t, y, p: 0.2 + 0.1 * torch.cos(y))
    bm = brownian_path(PRNGKey(0, device="cpu"), 0.0, 1.0, 16, shape=(2,),
                       dtype=torch.float64)
    y0 = torch.tensor([0.4, -1.1], dtype=torch.float64)
    grads = {}
    for adjoint in ("full", "reversible"):
        out = solve(get_solver("reversible_heun"), term, y0, TimeGrid.from_path(bm),
                    {"a": a, "c": 1.0}, adjoint=adjoint)
        grads[adjoint] = torch.autograd.grad(out.y_final.sum(), a)[0]
    torch.testing.assert_close(grads["reversible"], grads["full"], rtol=1e-9, atol=0)


def test_reversible_step_memory_is_flat_in_the_trajectory(monkeypatch):
    """Peak live tensor bytes of one Table-1 training step (EES(2,5), 64
    paths), counted op by op: with per-step increments the reversible
    step's peak does not grow from 8 to 64 steps; with the bulk buffer it
    grows by the buffer's extra rows plus one pass of the draw, nothing of
    the trajectory; the full adjoint's grows with the trajectory.  Slack 1%:
    the time grid itself (n+1 floats, 224 bytes more at 64 steps) is the
    only other tensor that scales with the step count."""
    from repro_torch.benchmarks.step_memory import step_peak
    from repro_torch.core import brownian

    paths, rows_per_pass = 64, 8
    row_bytes = paths * 16 * 4  # one step's float32 increments (d_z = 16)
    monkeypatch.setattr(brownian, "BULK_PASS_ELEMENTS", rows_per_pass * paths * 16)
    peak = {(n, label): step_peak(paths, n, device="cpu", **kw)
            for n in (8, 64)
            for label, kw in (("bulk", dict(adjoint="reversible")),
                              ("per-step", dict(adjoint="reversible",
                                                bulk_increments=False)),
                              ("full", dict(adjoint="full")))}
    assert peak[(64, "per-step")] <= 1.01 * peak[(8, "per-step")]
    growth = peak[(64, "bulk")] - peak[(8, "bulk")]
    assert growth <= 1.01 * ((64 - 8) * row_bytes + rows_per_pass * row_bytes)
    assert peak[(64, "full")] - peak[(8, "full")] > 5 * growth


# -- the recursive (checkpointed) adjoint -----------------------------------

def _assert_grads_equal(a, b):
    got_p, got_y, r = a
    want_p, want_y, w = b
    assert torch.equal(r.y_final, w.y_final) and torch.equal(r.ys, w.ys)
    assert np.array_equal(got_y, want_y)
    for g, x in zip(got_p, want_p):
        assert np.array_equal(g, x)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_recursive_grads_match_reference(model, spec, use_kernels):
    want_p, want_y = _ref_grads(model, spec, adjoint="recursive")
    full = spec + (":use_kernels=True" if use_kernels else "")
    got_p, got_y, r = _port_grads(model, full, adjoint="recursive")
    assert not r.diverged.any() and r.diverged.shape == (N_PATHS,)
    assert _rel(got_y, want_y) < 1e-10
    for g, w in zip(got_p, want_p):
        if np.abs(w).max() == 0:  # the readout and encoder weight: unused
            assert np.abs(g).max() == 0
        else:
            assert _rel(g, w) < 1e-10


@pytest.mark.parametrize("spec", SPECS)
def test_recursive_equals_full_bitwise(model, spec):
    """Every chunk size (the default for these segments of 4 is 2) gives the
    full adjoint's gradients bit for bit."""
    full = _port_grads(model, spec, adjoint="full")
    for kw in (dict(), dict(remat_chunk=1), dict(remat_chunk=2),
               dict(remat_chunk=4)):
        _assert_grads_equal(_port_grads(model, spec, adjoint="recursive", **kw), full)


@pytest.mark.parametrize("spec", ["ees25", "mcf-midpoint", "reversible_heun"])
def test_recursive_routes_bitwise(model, spec):
    """Kernel route, per-step increments and the guard change no bit of the
    recursive gradients."""
    base = _port_grads(model, spec, adjoint="recursive")
    for kw, s in ((dict(), spec + ":use_kernels=True"),
                  (dict(bulk_increments=False), spec),
                  (dict(guard=None), spec),
                  (dict(guard=None, bulk_increments=False), spec + ":use_kernels=True")):
        _assert_grads_equal(_port_grads(model, s, adjoint="recursive", **kw), base)


@pytest.mark.parametrize("seg, chunk", [(1, 1), (4, 2), (7, 1), (8, 2), (28, 4),
                                        (32, 4), (36, 6), (84, 7)])
def test_default_remat_chunk_is_the_references(seg, chunk):
    """``isqrt(segment)`` lowered until it divides the segment
    (reference ``core/adjoint.py``'s ``solve``)."""
    from repro_torch.core.adjoint import _default_remat_chunk

    assert _default_remat_chunk(seg) == chunk


def _counting_term(calls):
    term = lsde_term()

    def drift(t, z, p):
        calls.append(1)
        return term.drift(t, z, p)

    return type(term)(drift=drift, diffusion=term.diffusion, noise=term.noise)


@pytest.mark.parametrize("adjoint, replays", [("full", 0), ("recursive", 1)])
def test_recursive_backward_replays_each_step_once(model, adjoint, replays):
    """The forward keeps chunk inputs only; the backward runs each chunk's
    steps once more (EES(2,5)'s stage evaluations of 8 steps), and the full
    adjoint's backward runs none."""
    evals = N_STEPS * get_solver("ees25").evals_per_step
    params, y0, _ = model
    tp = lsde_params_from_jax(params, device="cpu")
    calls = []
    r = sdeint(_counting_term(calls), "ees25", 0.0, 1.0, N_STEPS,
               torch.from_numpy(np.array(y0)), args=tp, adjoint=adjoint,
               batch_keys=path_keys(PRNGKey(4, device="cpu"), 4), device="cpu")
    assert len(calls) == evals
    calls.clear()
    torch.autograd.grad(r.y_final.sum(), list(tp.parameters()), allow_unused=True)
    assert len(calls) == replays * evals


def test_recursive_chunk_errors(model):
    params, y0, _ = model
    tp = lsde_params_from_jax(params, device="cpu")
    key = PRNGKey(0, device="cpu")
    y = torch.from_numpy(np.array(y0))
    run = lambda **kw: sdeint(lsde_term(), "ees25", 0.0, 1.0, 8, y, key,  # noqa: E731
                              args=tp, device="cpu", **kw)
    with pytest.raises(ValueError, match="segment length must be divisible by remat_chunk"):
        run(adjoint="recursive", save_every=4, remat_chunk=3)
    with pytest.raises(ValueError, match="segment length must be divisible by remat_chunk"):
        run(adjoint="recursive", remat_chunk=3)
    with pytest.raises(ValueError, match="has no effect under adjoint='full'"):
        run(remat_chunk=2)
    with pytest.raises(ValueError, match="positive"):
        run(adjoint="recursive", remat_chunk=0)
    # save_at dense output runs under the recursive adjoint now; its chunks
    # must divide the grid
    with pytest.raises(ValueError, match="segment length must be divisible by remat_chunk"):
        solve(get_solver("ees25"), lsde_term(), y,
              __import__("repro_torch.core.brownian", fromlist=["x"]).brownian_path(
                  key, 0.0, 1.0, 8, shape=(D_Z,), dtype=torch.float64),
              tp, adjoint="recursive", save_at=torch.tensor([0.5]), remat_chunk=3)
    assert solve(get_solver("ees25"), lsde_term(), y,
                 __import__("repro_torch.core.brownian", fromlist=["x"]).brownian_path(
                     key, 0.0, 1.0, 8, shape=(D_Z,), dtype=torch.float64),
                 tp, adjoint="recursive", save_at=torch.tensor([0.5])).ys.shape == (1, D_Z)
    # the rest of the run is unchanged: n_steps must divide into segments
    with pytest.raises(ValueError, match="not divisible by save_every"):
        run(adjoint="recursive", save_every=3)


@pytest.mark.parametrize("spec", ["ees27", "reversible_heun"])
def test_recursive_on_padded_grid_equals_exact(model, spec):
    """A padded grid's chunks stop at its live steps: the gradients equal the
    exact grid's, bitwise (5 live steps of 8: chunks 2, 2, 1; the exact
    grid's default chunk is 1)."""
    params, y0, _ = model
    tp = lsde_params_from_jax(params, device="cpu")
    keys = path_keys(PRNGKey(8, device="cpu"), N_PATHS)
    h, active = 0.125, 5

    def grads(run):
        leaves = list(tp.parameters())
        y = torch.from_numpy(np.array(y0)).requires_grad_()
        yf = run(y)
        return torch.autograd.grad((yf ** 2).sum(), leaves + [y], allow_unused=True)

    padded = grads(lambda y: sdeint_ticks(
        lsde_term(), spec, 0.0, 1.0, 8, y, keys[None], args=tp, active_steps=[active],
        step_size=h, adjoint="recursive", device="cpu").y_final[0])
    exact = grads(lambda y: sdeint(
        lsde_term(), spec, 0.0, active * h, active, y, args=tp, batch_keys=keys,
        adjoint="recursive", device="cpu").y_final)
    for a, b in zip(padded, exact):
        assert (a is None and b is None) or torch.equal(a, b)


def test_recursive_batch_equals_loop(model):
    """A batch of keys gives each single-key solve's results and, summed over
    paths, its gradients (1e-12: the CPU's batched matmuls may sum in
    another order, ROADMAP C)."""
    params, y0, weights = model
    tp = lsde_params_from_jax(params, device="cpu")
    keys = path_keys(PRNGKey(6, device="cpu"), 4)
    wf = torch.from_numpy(weights[0][:4])
    leaves = list(tp.parameters())

    def run(k):
        y = torch.from_numpy(np.array(y0)).requires_grad_()
        r = sdeint(lsde_term(), "ees25:use_kernels=True", 0.0, 1.0, N_STEPS, y,
                   args=tp, save_every=4, adjoint="recursive", device="cpu", **k)
        return r, y

    rb, yb = run(dict(batch_keys=keys))
    gb = torch.autograd.grad((rb.y_final * wf).sum(), leaves + [yb], allow_unused=True)
    gl = [torch.zeros_like(x) for x in leaves + [yb]]
    for i in range(4):
        ri, yi = run(dict(key=keys[i]))
        torch.testing.assert_close(ri.y_final, rb.y_final[i], rtol=1e-12, atol=0)
        torch.testing.assert_close(ri.ys, rb.ys[i], rtol=1e-12, atol=0)
        g = torch.autograd.grad((ri.y_final * wf[i]).sum(), leaves + [yi],
                                allow_unused=True)
        gl = [a if b is None else a + b for a, b in zip(gl, g)]
    for a, b in zip(gl, gb):
        torch.testing.assert_close(a, torch.zeros_like(a) if b is None else b,
                                   rtol=1e-12, atol=1e-15)


ADD_ARGS = {"nu": 0.4, "sigma": 0.7}


def _additive(lib):
    xp = jnp if lib == "jax" else torch
    return dict(drift=lambda t, y, a: a["nu"] * (0.1 - y) + 0.1 * xp.sin(y),
                diffusion=lambda t, y, a: a["sigma"] * xp.ones_like(y),
                noise="additive")


@pytest.mark.parametrize("spec", ["ees25:use_kernels=True",
                                  "reversible-heun:use_kernels=True", "ees27"])
def test_recursive_prediffused_route(spec, monkeypatch):
    """An additive term under the recursive adjoint takes the prediffused
    route, as in the reference: bitwise equal to the full adjoint, the
    diffusion parameter's cotangent included, and within 1e-10 of the
    reference's recursive gradients."""
    from repro.core import SDETerm as JTerm
    from repro_torch.core import SDETerm
    from repro_torch.core import adjoint as tadj
    from repro_torch.core.solvers import _PrediffusedTerm

    seen = []
    orig = tadj._maybe_prediffuse
    monkeypatch.setattr(tadj, "_maybe_prediffuse", lambda *a: (
        lambda out: (seen.append(type(out[0])), out)[1])(orig(*a)))
    jk = jpath_keys(jax.random.PRNGKey(3), 3)
    tkeys = path_keys(PRNGKey(3, device="cpu"), 3)

    def port(adjoint):
        a = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for k, v in ADD_ARGS.items()}
        r = sdeint(SDETerm(**_additive("torch")), spec, 0.0, 1.0, 8,
                   torch.ones(3, dtype=torch.float64), args=a, batch_keys=tkeys,
                   save_every=4, adjoint=adjoint, device="cpu")
        loss = (r.y_final ** 2).sum() + r.ys.sum()
        return r, torch.autograd.grad(loss, list(a.values()))

    def ref(args):
        r = jsdeint(JTerm(**_additive("jax")), spec, 0.0, 1.0, 8,
                    jnp.ones(3, jnp.float64), None, args=args, batch_keys=jk,
                    save_every=4, adjoint="recursive")
        return jnp.sum(r.y_final ** 2) + jnp.sum(r.ys)

    rec, g_rec = port("recursive")
    full, g_full = port("full")
    assert seen == [_PrediffusedTerm, _PrediffusedTerm]
    assert torch.equal(rec.y_final, full.y_final) and torch.equal(rec.ys, full.ys)
    assert all(torch.equal(a, b) for a, b in zip(g_rec, g_full))
    assert float(g_rec[1]) != 0.0
    want = jax.grad(ref)({k: jnp.asarray(v, jnp.float64) for k, v in ADD_ARGS.items()})
    for got, k in zip(g_rec, ADD_ARGS):
        assert _rel(got.numpy(), np.asarray(want[k])) < 1e-10


def test_recursive_train_step_equals_full(model):
    """``make_sde_train_step(adjoint="recursive")`` takes the full step's
    update, bit for bit."""
    from repro_torch.nsde import lsde_readout, moment_mse
    from repro_torch.optim import adamw
    from repro_torch.train import make_sde_train_step

    params, _, _ = model
    tgt = torch.linspace(0.1, 0.3, 2, dtype=torch.float64).expand(N_PATHS, 2)
    out = {}
    for adjoint in ("full", "recursive"):
        tp = lsde_params_from_jax(params, device="cpu")
        opt = adamw(1e-2)
        step = make_sde_train_step(
            "ees25:use_kernels=True", lsde_term(), opt,
            y0_fn=lambda p: torch.zeros(D_Z, dtype=torch.float64) + p.encoder.b,
            loss_fn_result=lambda p, r: moment_mse(lsde_readout(p, r.ys)[..., 0], tgt),
            t0=0.0, t1=1.0, n_steps=N_STEPS, n_paths=N_PATHS, adjoint=adjoint,
            save_every=4, device="cpu")
        tp, _, m = step(tp, opt.init(list(tp.parameters())), PRNGKey(2, device="cpu"))
        out[adjoint] = (m, [p.detach().clone() for p in tp.parameters()])
    (mf, pf), (mr, pr) = out["full"], out["recursive"]
    assert torch.equal(mf["loss"], mr["loss"]) and not bool(mr["skipped"])
    assert torch.equal(mf["grad_norm"], mr["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(pf, pr))


def test_recursive_step_memory_is_sublinear(monkeypatch):
    """Peak live tensor bytes of one Table-1 training step (EES(2,5), 64
    paths, per-step increments, so no buffer grows with the steps): from 8
    to 64 steps the full adjoint's peak grows with the trajectory; the
    recursive adjoint's (default chunks of 2 and 4 steps) stays below it and
    grows by less than a quarter as much — it keeps 16 chunk inputs and one
    chunk's activations, where the full adjoint keeps 64 steps'."""
    from repro_torch.benchmarks.step_memory import step_peak

    peak = {(n, a): step_peak(64, n, device="cpu", adjoint=a, bulk_increments=False)
            for n in (8, 64) for a in ("full", "recursive", "reversible")}
    full = peak[(64, "full")] - peak[(8, "full")]
    rec = peak[(64, "recursive")] - peak[(8, "recursive")]
    assert peak[(64, "recursive")] < peak[(64, "full")]
    assert peak[(64, "reversible")] < peak[(64, "recursive")]
    assert 0 < rec < full / 4
