"""Solves over realized (adaptive) grids under the three adjoints, against
the reference (``tests/test_realized_grid.py``'s cases), and the port's own
bitwise invariants.

Against the reference (float64, x64 on): gradients of the full, recursive
and reversible adjoints on adaptively realized grids against ``jax.grad``
within 1e-8 relative; ``reversible_heun`` over the reference's own realized
grid within 1e-10; ``save_at`` cotangents (args and ``y0``), including a
save time inside the eps slack above a step boundary, within 1e-8.

Within the port, bitwise (the reference's own tests of these properties
fail on this tree, so the port proves its own): a batch of keys equals a
loop of single-key solves; ``bounded=True`` (realize, then solve) equals
``bounded=False`` (one controller pass); ``use_kernels=True`` equals the
plain path; per-step increments equal the bulk realization; the recursive
adjoint's gradients equal the full adjoint's.  A training step over
adaptive grids under the reversible adjoint matches the full adjoint's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.core import prng
from test_torch_vbt_adaptive import JARGS, TARGS, _np, _tkey, jvbt, terms, tvbt

KEY = jax.random.PRNGKey(0)
ADJOINTS = ["full", "recursive", "reversible"]


def targs():
    return {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for k, v in TARGS.items()}


def _grads(args):
    return {k: float(v.grad) for k, v in args.items()}


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_gradients_match_jax_grad(adjoint):
    """sdeint(..., "ees25:adaptive", adjoint=...) on the transient term."""
    jt, tt = terms("transient")
    keys = jax.random.split(KEY, 2)

    def jloss(a):
        r = J.sdeint(jt, "ees25:adaptive", 0.0, 1.0, 128, jnp.ones(2), None,
                     args=a, adjoint=adjoint, rtol=1e-2, atol=1e-4,
                     batch_keys=keys)
        return jnp.mean(r.y_final ** 2)

    want = jax.grad(jloss)(JARGS)
    args = targs()
    r = T.sdeint(tt, "ees25:adaptive", 0.0, 1.0, 128,
                 torch.ones(2, dtype=torch.float64), None, args=args,
                 adjoint=adjoint, rtol=1e-2, atol=1e-4, batch_keys=_tkey(keys),
                 device="cpu")
    (r.y_final ** 2).mean().backward()
    for k, g in _grads(args).items():
        np.testing.assert_allclose(g, float(want[k]), rtol=1e-8)


def test_reversible_heun_solves_the_references_grid():
    """Solvers without an estimator solve over a realized grid: the
    reference's, under all three adjoints (exact reconstruction)."""
    jt, tt = terms("ou")
    keys = jax.random.split(KEY, 3)
    rg = jax.vmap(lambda k: J.realize_grid("ees25", jt, jnp.ones(3), jvbt(k),
                                           JARGS, rtol=1e-3, max_steps=64))(keys)
    grid = T.TimeGrid(torch.tensor(np.asarray(rg.grid.ts)), tvbt(_tkey(keys)),
                      0.0, 1.0, hs=torch.tensor(np.asarray(rg.grid.hs)),
                      n_active=int(np.max(rg.n_accepted)))
    rh_j, rh_t = J.get_solver("reversible_heun"), T.get_solver("reversible_heun")

    def jloss(a, k, ts, hs):
        g = J.TimeGrid(ts, hs, jvbt(k), 0.0, 1.0)
        return jnp.sum(J.solve(rh_j, jt, jnp.ones(3), g, a).y_final ** 2)

    want_y = jax.vmap(lambda k, ts, hs: J.solve(
        rh_j, jt, jnp.ones(3), J.TimeGrid(ts, hs, jvbt(k), 0.0, 1.0), JARGS
    ).y_final)(keys, rg.grid.ts, rg.grid.hs)
    want_g = jax.grad(lambda a: jnp.sum(jax.vmap(
        lambda k, ts, hs: jloss(a, k, ts, hs))(keys, rg.grid.ts, rg.grid.hs)))(JARGS)
    outs = {}
    for adjoint in ADJOINTS:
        args = targs()
        out = T.solve(rh_t, tt, torch.ones(3, 3, dtype=torch.float64), grid, args,
                      adjoint=adjoint, batch_dims=1)
        (out.y_final ** 2).sum().backward()
        outs[adjoint] = out.y_final.detach()
        np.testing.assert_allclose(_np(out.y_final), want_y, rtol=0, atol=1e-10)
        for k, g in _grads(args).items():
            np.testing.assert_allclose(g, float(want_g[k]), rtol=1e-10)
    assert torch.equal(outs["full"], outs["reversible"])


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_save_at_cotangents_match_jax_grad(adjoint):
    jt, tt = terms("ou")
    ts = [0.0, 0.23, 0.5, 0.77, 1.0]

    def jloss(a, y):
        r = J.sdeint(jt, "ees25:adaptive", 0.0, 1.0, 128, y, KEY, args=a,
                     adjoint=adjoint, rtol=1e-2, save_at=jnp.array(ts))
        return jnp.sum(r.ys ** 2)

    wa, wy = jax.grad(jloss, argnums=(0, 1))(JARGS, jnp.ones(2))
    args = targs()
    y0 = torch.ones(2, dtype=torch.float64, requires_grad=True)
    r = T.sdeint(tt, "ees25:adaptive", 0.0, 1.0, 128, y0, _tkey(KEY), args=args,
                 adjoint=adjoint, rtol=1e-2, save_at=ts, device="cpu")
    (r.ys ** 2).sum().backward()
    for k, g in _grads(args).items():
        np.testing.assert_allclose(g, float(wa[k]), rtol=1e-8)
    np.testing.assert_allclose(_np(y0.grad), wy, rtol=1e-8)


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_save_at_step_boundary_cotangent_not_double_counted(adjoint):
    """A save inside the eps slack above an interior step boundary belongs
    to one step: every adjoint matches autodiff of the reference there."""
    jt, tt = terms("ou")
    ts = [0.375 + 2e-10, 1.0]
    jbm = J.brownian_path(KEY, 0.0, 1.0, 8, shape=(3,), dtype=jnp.float64)
    tbm = T.brownian_path(_tkey(KEY), 0.0, 1.0, 8, shape=(3,), dtype=torch.float64)

    def jloss(a):
        out = J.solve(J.get_solver("ees25"), jt, jnp.ones(3), jbm, a,
                      adjoint=adjoint, save_at=jnp.array(ts))
        return jnp.sum(out.ys ** 2)

    want = jax.grad(jloss)(JARGS)
    args = targs()
    out = T.solve(T.get_solver("ees25"), tt, torch.ones(3, dtype=torch.float64),
                  tbm, args, adjoint=adjoint, save_at=ts)
    (out.ys ** 2).sum().backward()
    for k, g in _grads(args).items():
        np.testing.assert_allclose(g, float(want[k]), rtol=1e-8)


def test_reconstruction_drift_bounded_on_stiff_term():
    """The reverse step run backward over a realized grid lands within
    O(h^3)-accumulated distance of y0 on the stiff term."""
    _, tt = terms("transient")
    solver = T.get_solver("ees25")
    y0 = torch.ones(1, 2, dtype=torch.float64)
    rg = T.realize_grid(solver, tt, y0, tvbt(_tkey(KEY)[None], shape=(2,)), TARGS,
                        rtol=1e-4, atol=1e-6, max_steps=256)
    grid = rg.grid
    state = T.solve(solver, tt, y0, grid, TARGS, batch_dims=1).y_final
    for n in range(grid.n_live - 1, -1, -1):
        t, h = grid.step_th(n, state)
        prev = solver.reverse(tt, state, t, h, grid.increment(n), TARGS)
        state = torch.where(grid.live(n)[:, None], prev, state)
    assert float((state - y0).abs().max()) < 1e-5


# -- the port's own invariants ---------------------------------------------------

def _adaptive(keys, spec="ees25:adaptive", **kw):
    _, tt = terms("ou")
    return T.sdeint(tt, spec, 0.0, 1.0, 128, torch.ones(3, dtype=torch.float64),
                    None, args=TARGS, rtol=1e-3, save_at=[0.5, 1.0],
                    batch_keys=keys, device="cpu", **kw)


def _assert_same(a, b, counts=True):
    assert torch.equal(a.y_final, b.y_final) and torch.equal(a.ys, b.ys)
    assert torch.equal(a.t_final, b.t_final)
    if counts:
        assert torch.equal(a.n_accepted, b.n_accepted)
        assert torch.equal(a.n_rejected, b.n_rejected)


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_batch_equals_loop(adjoint):
    """Realize + solve of a key batch equals single-key solves, bitwise."""
    keys = prng.split(prng.PRNGKey(7, device="cpu"), 3)
    with torch.no_grad():
        batched = _adaptive(keys, adjoint=adjoint)
        for i in range(3):
            solo = _adaptive(keys[i:i + 1], adjoint=adjoint)
            assert torch.equal(batched.y_final[i:i + 1], solo.y_final)
            assert torch.equal(batched.ys[i:i + 1], solo.ys)
            assert torch.equal(batched.n_accepted[i:i + 1], solo.n_accepted)
            assert torch.equal(batched.n_rejected[i:i + 1], solo.n_rejected)


def test_bounded_equals_unbounded():
    keys = prng.split(prng.PRNGKey(8, device="cpu"), 4)
    with torch.no_grad():
        _assert_same(_adaptive(keys), _adaptive(keys, bounded=False))


@pytest.mark.parametrize("bounded", [False, True])
def test_kernels_equal_plain(bounded):
    keys = prng.split(prng.PRNGKey(9, device="cpu"), 4)
    with torch.no_grad():
        _assert_same(_adaptive(keys, "ees25:adaptive,use_kernels=True",
                               bounded=bounded),
                     _adaptive(keys, bounded=bounded))


def test_kernel_gradients_equal_plain_and_recursive_equals_full():
    _, tt = terms("transient")
    keys = prng.split(prng.PRNGKey(10, device="cpu"), 3)
    grads = {}
    for spec, adjoint in [("ees25:adaptive", "full"),
                          ("ees25:adaptive", "recursive"),
                          ("ees25:adaptive", "reversible"),
                          ("ees25:adaptive,use_kernels=True", "reversible")]:
        args = targs()
        r = T.sdeint(tt, spec, 0.0, 1.0, 128, torch.ones(2, dtype=torch.float64),
                     None, args=args, adjoint=adjoint, rtol=1e-3, batch_keys=keys,
                     device="cpu")
        (r.y_final ** 2).mean().backward()
        grads[(spec, adjoint)] = _grads(args)
    assert grads[("ees25:adaptive", "full")] == grads[("ees25:adaptive", "recursive")]
    assert (grads[("ees25:adaptive", "reversible")]
            == grads[("ees25:adaptive,use_kernels=True", "reversible")])
    for k, g in grads[("ees25:adaptive", "full")].items():
        np.testing.assert_allclose(grads[("ees25:adaptive", "reversible")][k], g,
                                   rtol=1e-4)


def test_guard_flags_per_path_in_both_modes():
    keys = prng.split(prng.PRNGKey(11, device="cpu"), 3)
    with torch.no_grad():
        for bounded in (False, True):
            out = _adaptive(keys, bounded=bounded, guard=1e6)
            assert out.diverged.shape == (3,) and not out.diverged.any()
            tight = _adaptive(keys, bounded=bounded, guard=0.5)
            assert tight.diverged.all()
            _assert_same(out, tight)


def test_realized_grid_structure():
    _, tt = terms("transient")
    keys = prng.split(prng.PRNGKey(12, device="cpu"), 2)
    rg = T.realize_grid("ees25", tt, torch.ones(2, 3, dtype=torch.float64),
                        tvbt(keys), TARGS, rtol=1e-3, max_steps=64)
    ts, hs, na = rg.grid.ts, rg.grid.hs, rg.n_accepted
    assert ts.dtype == hs.dtype == torch.float64 and not rg.grid.is_uniform
    for i in range(2):
        k = int(na[i])
        assert float(ts[i, 0]) == 0.0 and torch.all(ts[i, k:] == rg.t_final[i])
        assert torch.all(hs[i, :k] > 0) and torch.all(hs[i, k:] == 0)
        torch.testing.assert_close(ts[i, 1:k + 1] - ts[i, :k], hs[i, :k],
                                   rtol=0, atol=1e-15)
    assert rg.grid.n_active == int(na.max())


def test_sdeint_ticks_runs_adaptive_ticks():
    keys = prng.split(prng.PRNGKey(13, device="cpu"), 6).reshape(2, 3, 2)
    _, tt = terms("ou")
    with torch.no_grad():
        out = T.sdeint_ticks(tt, "ees25:adaptive", 0.0, 1.0, 128,
                             torch.ones(3, dtype=torch.float64), keys, args=TARGS,
                             rtol=1e-3, save_at=[0.5, 1.0], bounded=False,
                             device="cpu")
        assert isinstance(out, T.AdaptiveResult) and out.ys.shape == (2, 3, 2, 3)
        for t in range(2):
            _assert_same(type(out)(*(x[t] for x in out[:6]), None),
                         _adaptive(keys[t], bounded=False))


def test_train_step_on_adaptive_grids_matches_full_adjoint():
    """make_sde_train_step("ees25:adaptive", adjoint="reversible") trains
    the Langevin model over realized grids; its first step's loss equals the
    full adjoint's bitwise and its gradient norm agrees to 1e-4."""
    from repro_torch.nsde import init_lsde, lsde_term
    from repro_torch.optim import adamw
    from repro_torch.train import make_sde_train_step

    seen = {}
    for adjoint in ("reversible", "full"):
        params = init_lsde(0, 1, 4, 8, dtype=torch.float64, device="cpu")
        opt = adamw(1e-2)
        step = make_sde_train_step(
            "ees25:adaptive", lsde_term(), opt, lambda p: p.encoder.b,
            lambda p, r: ((r.y_final - 0.2) ** 2).mean(), t0=0.0, t1=1.0,
            n_steps=64, n_paths=4, adjoint=adjoint, rtol=1e-2, device="cpu")
        _, _, m = step(params, opt.init(list(params.parameters())),
                       prng.PRNGKey(42, device="cpu"))
        assert not bool(m["skipped"])
        seen[adjoint] = (float(m["loss"]), float(m["grad_norm"]))
    assert seen["reversible"][0] == seen["full"][0]
    np.testing.assert_allclose(seen["reversible"][1], seen["full"][1], rtol=1e-4)


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_per_step_increments_equal_bulk(adjoint):
    """bulk_increments=False (the forward sweep streams W(ts[n]) from the
    tree; the reversible backward queries each step) equals the bulk
    realization bitwise, results and gradients."""
    _, tt = terms("transient")
    keys = prng.split(prng.PRNGKey(14, device="cpu"), 3)
    out = {}
    for bulk in (True, False):
        args = targs()
        r = T.sdeint(tt, "ees25:adaptive", 0.0, 1.0, 128,
                     torch.ones(2, dtype=torch.float64), None, args=args,
                     adjoint=adjoint, rtol=1e-3, save_at=[0.3, 1.0],
                     batch_keys=keys, bulk_increments=bulk, device="cpu")
        (r.ys ** 2).sum().backward()
        out[bulk] = (r.y_final.detach(), r.ys.detach(), _grads(args))
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    assert out[True][2] == out[False][2]
