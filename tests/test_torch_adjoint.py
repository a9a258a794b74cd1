"""The reversible adjoint of the port against the reference's, and against the
port's own full adjoint.

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
from repro_torch.device import NotYetPorted
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


def _ref_grads(model, spec, adjoint="reversible"):
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


def test_recursive_adjoint_still_raises(model):
    params, y0, _ = model
    with pytest.raises(NotYetPorted, match="recursive"):
        sdeint(lsde_term(), "ees25", 0.0, 1.0, 2, torch.zeros(D_Z, dtype=torch.float64),
               PRNGKey(0, device="cpu"), args=lsde_params_from_jax(params, device="cpu"),
               adjoint="recursive", device="cpu")


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
