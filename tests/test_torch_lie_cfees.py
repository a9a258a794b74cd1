"""Lie groups, CF-EES and the geometric baselines of the port against the
reference (``tests/test_lie_cfees.py`` mirrored), float64.

* each group's ``exp_action``, ``project`` and ``distance_from_manifold``
  against the reference: SO(3) through Rodrigues within 1e-14; SO(n) and
  the sphere within 1e-12 relative (the port's ``expm`` runs the Pade
  algorithm of ``jax.scipy.linalg.expm`` batched, within 1e-13 of it: the
  two agree to rounding, not bitwise);
* all five solvers' ``step`` and ``reverse`` on SO(3), the torus, the
  sphere and the Kuramoto product group, within 1e-12 relative;
* the flat collapse: CF-EES on :class:`Euclidean` is the port's 2N EES
  step, bit for bit;
* preservation (distance below 1e-12), the reverse-error slopes (CF-EES
  above 5.5, GeoEM below 3.5);
* Kuramoto gradients: full against reversible (1e-6, the reference's
  tolerance) against recursive (bitwise to full) in the port, and the port
  against the reference (1e-10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import lie as jlie
from repro_torch import core as T
from repro_torch.core import lie as tlie
from repro_torch.core import prng
from repro_torch.core.brownian import brownian_path

RTOL = 1e-12
SOLVERS = ["cfees25", "cfees27", "geo-em", "cg2", "rkmk2"]
F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _rotations(rng, batch):
    q, _ = np.linalg.qr(rng.normal(size=(batch, 3, 3)))
    return q * np.sign(np.linalg.det(q))[:, None, None]


# ---------------------------------------------------------------------------
# Terms, written once for both libraries.
# ---------------------------------------------------------------------------

def _so3_term(lib):
    stack = (lambda xs: jnp.stack(xs, axis=-1)) if lib == "jax" else \
        (lambda xs: torch.stack(xs, dim=-1))
    mod = J if lib == "jax" else T

    def xi(t, y, a):
        return stack([0.1 + 0.3 * y[..., 2, 0], -(0.25 + 0.2 * y[..., 1, 2]),
                      0.9 + 0.2 * y[..., 0, 0]])

    def xig(t, y, a):
        return stack([0.8 + 0.15 * y[..., 2, 2], 0.15 + 0.25 * y[..., 0, 1],
                      0.35 - 0.2 * y[..., 1, 1]])

    return mod.ManifoldSDETerm(group=mod.SO3(), drift=xi, diffusion=xig,
                               noise="diagonal")


def _skew(lib, n):
    if lib == "jax":
        iu = jnp.triu_indices(n, 1)

        def to_skew(v):
            S = jnp.zeros(v.shape[:-1] + (n, n), v.dtype).at[..., iu[0], iu[1]].set(v)
            return S - jnp.swapaxes(S, -1, -2)
    else:
        iu = torch.triu_indices(n, n, 1)

        def to_skew(v):
            S = v.new_zeros(tuple(v.shape[:-1]) + (n, n))
            S[..., iu[0], iu[1]] = v
            return S - S.transpose(-1, -2)
    return to_skew


def _sphere_term(lib, n=4):
    mod = J if lib == "jax" else T
    tanh = jnp.tanh if lib == "jax" else torch.tanh
    to_skew = _skew(lib, n)
    return mod.ManifoldSDETerm(
        group=mod.SphereAction(n),
        drift=lambda t, y, a: to_skew(tanh(y @ a.T)),
        diffusion=lambda t, y, a: 0.2,
        noise="general",
        noise_apply=lambda sig, dw: to_skew(sig * dw),
    )


def _torus_term(lib):
    mod = J if lib == "jax" else T
    sin = jnp.sin if lib == "jax" else torch.sin
    cos = jnp.cos if lib == "jax" else torch.cos
    return mod.ManifoldSDETerm(group=mod.Torus(),
                               drift=lambda t, y, a: 1.5 + sin(y),
                               diffusion=lambda t, y, a: 0.5 + 0.2 * cos(y),
                               noise="diagonal")


def _kuramoto_term(lib):
    mod = J if lib == "jax" else T
    if lib == "jax":
        coupling = lambda th: jnp.mean(jnp.sin(th[..., None, :] - th[..., :, None]), axis=-1)  # noqa: E731
        ones, zeros = jnp.ones_like, jnp.zeros_like
    else:
        coupling = lambda th: torch.sin(th[..., None, :] - th[..., :, None]).mean(-1)  # noqa: E731
        ones, zeros = torch.ones_like, torch.zeros_like

    def drift(t, y, p):
        th, om = y
        return (om, p["K"] * coupling(th) - om)

    def diff(t, y, p):
        th, om = y
        return (zeros(th), p["D"] * ones(om))

    return mod.ManifoldSDETerm(group=mod.Product([mod.Torus(), mod.Euclidean()]),
                               drift=drift, diffusion=diff, noise="diagonal")


# ---------------------------------------------------------------------------
# Groups.
# ---------------------------------------------------------------------------

class TestRodrigues:
    @pytest.mark.parametrize("w", [[0.3, -0.7, 0.5], [1e-5, 2e-5, -1e-5],
                                   [1e-12, -1e-13, 1e-12], [2.0, 1.0, -2.5]])
    def test_matches_reference(self, w):
        _close(tlie.rodrigues(_t(w)), jlie.rodrigues(jnp.asarray(w, jnp.float64)), 1e-14)

    def test_matches_matrix_exp(self):
        w = _t([0.3, -0.7, 0.5])
        _close(tlie.rodrigues(w), torch.linalg.matrix_exp(tlie.skew_from_vec(w)))

    def test_grad_no_nan_at_zero_and_equals_reference(self):
        w = torch.zeros(3, dtype=F64, requires_grad=True)
        tlie.rodrigues(w)[0, 1].backward()
        want = jax.grad(lambda v: jlie.rodrigues(v)[0, 1])(jnp.zeros(3, jnp.float64))
        assert torch.isfinite(w.grad).all()
        np.testing.assert_array_equal(w.grad.numpy(), np.asarray(want))

    def test_skew_vec_roundtrip(self):
        w = _t(np.random.default_rng(0).normal(size=(4, 3)))
        torch.testing.assert_close(tlie.vec_from_skew(tlie.skew_from_vec(w)), w,
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(tlie.skew_from_vec(w).numpy(),
                                      np.asarray(jlie.skew_from_vec(jnp.asarray(w.numpy()))))


@pytest.mark.parametrize("scale", [1e-3, 0.1, 0.5, 1.5, 3.0, 10.0, 100.0])
def test_expm_matches_the_reference_expm(scale):
    """Every Pade degree and the squarings: within 1e-13 relative, and as
    orthogonal as the reference's on skew arguments."""
    A = np.random.default_rng(6).normal(size=(20, 6, 6)) * scale
    A = A - np.swapaxes(A, -1, -2)
    got, want = tlie.expm(_t(A)), jax.scipy.linalg.expm(jnp.asarray(A))
    _close(got, want, 1e-13)
    gap = float(T.SOn(6).distance_from_manifold(got))
    assert gap <= max(4 * float(J.SOn(6).distance_from_manifold(want)), 1e-15)


def _group_case(name, rng):
    """(port group, reference group, v, y, off-manifold y) with two leading
    path axes."""
    if name == "so3":
        y = _rotations(rng, 6).reshape(2, 3, 3, 3)
        return T.SO3(), J.SO3(), rng.normal(size=(2, 3, 3)), y, y + 0.01 * rng.normal(size=y.shape)
    if name == "son":
        v = rng.normal(size=(2, 3, 5, 5))
        v = 0.4 * (v - np.swapaxes(v, -1, -2))
        y, _ = np.linalg.qr(rng.normal(size=(2, 3, 5, 5)))
        return T.SOn(5), J.SOn(5), v, y, y + 0.01
    if name == "sphere":
        v = rng.normal(size=(2, 3, 4, 4))
        v = v - np.swapaxes(v, -1, -2)
        y = rng.normal(size=(2, 3, 4))
        y /= np.linalg.norm(y, axis=-1, keepdims=True)
        return T.SphereAction(4), J.SphereAction(4), v, y, 1.1 * y
    if name == "torus":
        y = rng.uniform(-np.pi, np.pi, size=(2, 3, 5))
        return T.Torus(), J.Torus(), 4.0 * rng.normal(size=(2, 3, 5)), y, 2.0 * y
    if name == "euclidean":
        return T.Euclidean(), J.Euclidean(), rng.normal(size=(2, 3)), rng.normal(size=(2, 3)), None
    raise AssertionError(name)


GROUPS = ["so3", "son", "sphere", "torus", "euclidean"]


@pytest.mark.parametrize("name", GROUPS)
def test_group_exp_action_matches_reference(name):
    tg, jg, v, y, _ = _group_case(name, np.random.default_rng(1))
    _close(tg.exp_action(_t(v), _t(y)), jg.exp_action(jnp.asarray(v), jnp.asarray(y)))


@pytest.mark.parametrize("name", GROUPS)
def test_group_project_and_distance_match_reference(name):
    tg, jg, _, y, off = _group_case(name, np.random.default_rng(2))
    for pts in (y, off):
        if pts is None:
            continue
        _close(tg.project(_t(pts)), jg.project(jnp.asarray(pts)))
        _close(tg.distance_from_manifold(_t(pts)),
               jg.distance_from_manifold(jnp.asarray(pts)))
        _close(tg.distance_from_manifold(tg.project(_t(pts))),
               jg.distance_from_manifold(jg.project(jnp.asarray(pts))))


def test_product_group_matches_reference():
    rng = np.random.default_rng(3)
    v = (rng.normal(size=(3, 4)) * 4, rng.normal(size=(3, 4)))
    y = (rng.uniform(-np.pi, np.pi, size=(3, 4)), rng.normal(size=(3, 4)))
    tg, jg = T.Product([T.Torus(), T.Euclidean()]), J.Product([J.Torus(), J.Euclidean()])
    tv, ty = tuple(map(_t, v)), tuple(map(_t, y))
    jv, jy = tuple(map(jnp.asarray, v)), tuple(map(jnp.asarray, y))
    _close(tg.exp_action(tv, ty), jg.exp_action(jv, jy))
    _close(tg.project((2 * ty[0], ty[1])), jg.project((2 * jy[0], jy[1])))
    _close(tg.distance_from_manifold((2 * ty[0], ty[1])),
           jg.distance_from_manifold((2 * jy[0], jy[1])))


def test_torus_wrap_rounds_half_to_even_with_zero_gradient():
    x = _t([np.pi, -np.pi, 3 * np.pi, 0.5, -7.0]).requires_grad_()
    w = T.Torus.wrap(x)
    np.testing.assert_array_equal(w.detach().numpy(),
                                  np.asarray(J.Torus.wrap(jnp.asarray(x.detach().numpy()))))
    w.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(5))


# ---------------------------------------------------------------------------
# Solvers.
# ---------------------------------------------------------------------------

def _solver_case(group, rng):
    """(port term, ref term, y0 pair, dW pair, args pair) for one step."""
    if group == "so3":
        y = _rotations(rng, 4)
        dw = 0.3 * rng.normal(size=(4, 3))
        return _so3_term("torch"), _so3_term("jax"), y, dw, None
    if group == "sphere":
        y = rng.normal(size=(4, 4))
        y /= np.linalg.norm(y, axis=-1, keepdims=True)
        W = 0.3 * rng.normal(size=(6, 4))
        return _sphere_term("torch"), _sphere_term("jax"), y, 0.3 * rng.normal(size=(4, 6)), W
    if group == "torus":
        y = rng.uniform(-np.pi, np.pi, size=(4, 5))
        return _torus_term("torch"), _torus_term("jax"), y, 0.4 * rng.normal(size=(4, 5)), None
    if group == "product":
        y = (rng.uniform(-np.pi, np.pi, size=(4, 5)), rng.normal(size=(4, 5)))
        dw = (0.3 * rng.normal(size=(4, 5)), 0.3 * rng.normal(size=(4, 5)))
        return (_kuramoto_term("torch"), _kuramoto_term("jax"), y, dw,
                {"K": 2.0, "D": 0.3})
    raise AssertionError(group)


def _both(x, conv):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(conv(v) for v in x)
    if isinstance(x, dict):
        return {k: conv(np.float64(v)) for k, v in x.items()}
    return conv(x)


@pytest.mark.parametrize("group", ["so3", "sphere", "torus", "product"])
@pytest.mark.parametrize("spec", SOLVERS)
def test_step_and_reverse_match_reference(spec, group):
    tterm, jterm, y, dw, args = _solver_case(group, np.random.default_rng(4))
    ts, js = T.get_solver(spec), J.get_solver(spec)
    ty, jy = _both(y, _t), _both(y, jnp.asarray)
    tw, jw = _both(dw, _t), _both(dw, jnp.asarray)
    ta, ja = _both(args, _t), _both(args, jnp.asarray)
    t_next = ts.step(tterm, ty, _t(0.3), 0.1, tw, ta)
    _close(t_next, js.step(jterm, jy, jnp.float64(0.3), 0.1, jw, ja))
    _close(ts.reverse(tterm, t_next, _t(0.3), 0.1, tw, ta),
           js.reverse(jterm, _both(_np(t_next), jnp.asarray), jnp.float64(0.3), 0.1, jw, ja))


@pytest.mark.parametrize("pair", [("cfees25", "ees25"), ("cfees27", "ees27"),
                                  ("cfees25:x=0.3", "ees25:x=0.3")])
def test_flat_collapse_is_bitwise_the_2n_step(pair):
    """On Euclidean space CF-EES is *identically* the port's EES 2N step."""
    f = lambda t, y, a: torch.tanh(y) * a  # noqa: E731
    g = lambda t, y, a: 0.2 * torch.cos(y)  # noqa: E731
    term_e = T.SDETerm(drift=f, diffusion=g, noise="diagonal")
    term_m = T.ManifoldSDETerm(group=T.Euclidean(), drift=f, diffusion=g, noise="diagonal")
    rng = np.random.default_rng(5)
    y0, dW = _t(rng.normal(size=(8, 3))), _t(0.1 * rng.normal(size=(8, 3)))
    a = _t(0.9)
    ye = T.get_solver(pair[1]).step(term_e, y0, _t(0.0), 0.1, dW, a)
    ym = T.get_solver(pair[0]).step(term_m, y0, _t(0.0), 0.1, dW, a)
    np.testing.assert_array_equal(ye.numpy(), ym.numpy())


def test_flat_collapse_matches_the_reference_collapse():
    f_j = lambda t, y, a: jnp.tanh(y) * a  # noqa: E731
    g_j = lambda t, y, a: 0.2 * jnp.cos(y)  # noqa: E731
    term_j = J.ManifoldSDETerm(group=J.Euclidean(), drift=f_j, diffusion=g_j)
    term_t = T.ManifoldSDETerm(group=T.Euclidean(), drift=lambda t, y, a: torch.tanh(y) * a,
                               diffusion=lambda t, y, a: 0.2 * torch.cos(y))
    y0, dW = [0.3, -1.2, 0.8], [0.05, -0.02, 0.01]
    want = J.cfees25_solver().step(term_j, jnp.asarray(y0), 0.0, 0.1, jnp.asarray(dW),
                                   jnp.float64(0.9))
    got = T.cfees25_solver().step(term_t, _t(y0), 0.0, 0.1, _t(dW), _t(0.9))
    _close(got, want)


# ---------------------------------------------------------------------------
# Preservation and reversibility, through the port's solve.
# ---------------------------------------------------------------------------

KEY = prng.PRNGKey(0, device="cpu")


@pytest.mark.parametrize("spec", SOLVERS)
def test_so3_stays_orthogonal(spec):
    term = _so3_term("torch")
    bm = brownian_path(KEY, 0.0, 1.0, 100, shape=(3,), dtype=F64)
    r = T.solve(T.get_solver(spec), term, torch.eye(3, dtype=F64), bm, None)
    assert float(term.group.distance_from_manifold(r.y_final)) < 1e-12


def test_sphere_stays_unit():
    term = _sphere_term("torch")
    W = 0.3 * prng.normal(KEY, (6, 4), F64)
    y0 = torch.zeros(4, dtype=F64)
    y0[0] = 1.0
    bm = brownian_path(KEY, 0.0, 1.0, 50, shape=(6,), dtype=F64)
    r = T.solve(T.cfees25_solver(), term, y0, bm, W)
    assert abs(float(torch.linalg.norm(r.y_final)) - 1.0) < 1e-12


def test_torus_stays_wrapped():
    term = T.ManifoldSDETerm(group=T.Torus(), drift=lambda t, y, a: 5.0 * torch.ones_like(y),
                             diffusion=lambda t, y, a: torch.ones_like(y))
    bm = brownian_path(KEY, 0.0, 5.0, 100, shape=(6,), dtype=F64)
    r = T.solve(T.cfees25_solver(), term, torch.zeros(6, dtype=F64), bm, None)
    assert float(r.y_final.abs().max()) <= np.pi + 1e-12
    assert float(term.group.distance_from_manifold(r.y_final)) < 1e-12


def test_son_general():
    n = 5
    M = prng.normal(prng.split(KEY)[0], (n, n), F64)

    def xi(t, y, a):
        S = M @ y
        return 0.3 * (S - S.T)

    term = T.ManifoldSDETerm(group=T.SOn(n), drift=xi, noise="none")
    grid = T.TimeGrid.uniform(0.0, 1.0, 20, None, dtype=F64, device="cpu")
    r = T.solve(T.cfees25_solver(), term, torch.eye(n, dtype=F64), grid, None)
    assert float(term.group.distance_from_manifold(r.y_final)) < 1e-12


def _reverse_slope(spec):
    term = _so3_term("torch")
    solver = T.get_solver(spec)
    Y0 = torch.eye(3, dtype=F64)
    hs = np.array([0.1, 0.05, 0.025])
    errs = []
    for h in hs:
        y1 = solver.step(term, Y0, 0.0, h, torch.zeros(3, dtype=F64), None)
        y0b = solver.reverse(term, y1, 0.0, h, torch.zeros(3, dtype=F64), None)
        errs.append(float((y0b - Y0).abs().max()))
    return float(np.polyfit(np.log(hs), np.log(errs), 1)[0])


def test_cfees25_reverse_error_is_order_six():
    """Theorem 3.2: CF-EES(2,5) recovers the initial condition to O(h^6)."""
    assert _reverse_slope("cfees25") > 5.5


def test_geo_em_is_not_effectively_symmetric():
    assert _reverse_slope("geo-em") < 3.5


# ---------------------------------------------------------------------------
# Kuramoto gradients under the three adjoints.
# ---------------------------------------------------------------------------

N_OSC = 5


def _port_kuramoto_grads(adjoint, bulk=True):
    term = _kuramoto_term("torch")
    y0 = (torch.linspace(-1.0, 1.0, N_OSC, dtype=F64), torch.zeros(N_OSC, dtype=F64))
    p = {"K": torch.tensor(2.0, dtype=F64, requires_grad=True),
         "D": torch.tensor(0.05, dtype=F64, requires_grad=True)}
    bm = brownian_path(KEY, 0.0, 2.0, 200, shape=((N_OSC,), (N_OSC,)), dtype=F64)
    r = T.solve(T.cfees25_solver(), term, y0, bm, p, adjoint=adjoint, save_every=50,
                bulk_increments=bulk)
    th, om = r.y_final
    ths, _ = r.ys
    loss = torch.cos(th).sum() + 0.1 * (om ** 2).sum() + 0.01 * (ths ** 2).sum()
    gK, gD = torch.autograd.grad(loss, [p["K"], p["D"]])
    return loss.item(), np.array([gK.item(), gD.item()])


@pytest.fixture(scope="module")
def kuramoto_full():
    return _port_kuramoto_grads("full")


def test_kuramoto_reversible_gradients_match_full(kuramoto_full):
    _, gf = kuramoto_full
    for bulk in (True, False):
        _, gr = _port_kuramoto_grads("reversible", bulk)
        np.testing.assert_allclose(gr, gf, rtol=1e-6)


def test_kuramoto_recursive_gradients_equal_full(kuramoto_full):
    lf, gf = kuramoto_full
    lr, gr = _port_kuramoto_grads("recursive")
    assert lr == lf
    np.testing.assert_array_equal(gr, gf)


def test_kuramoto_gradients_match_reference(kuramoto_full):
    term = _kuramoto_term("jax")
    y0 = (jnp.linspace(-1.0, 1.0, N_OSC), jnp.zeros(N_OSC))

    def loss(p):
        bm = J.brownian_path(jax.random.PRNGKey(0), 0.0, 2.0, 200,
                             shape=((N_OSC,), (N_OSC,)), dtype=jnp.float64)
        r = J.solve(J.cfees25_solver(), term, y0, bm, p, adjoint="full", save_every=50)
        th, om = r.y_final
        ths, _ = r.ys
        return jnp.sum(jnp.cos(th)) + 0.1 * jnp.sum(om ** 2) + 0.01 * jnp.sum(ths ** 2)

    p = {"K": jnp.float64(2.0), "D": jnp.float64(0.05)}
    lv, g = jax.value_and_grad(loss)(p)
    lf, gf = kuramoto_full
    assert abs(lf - float(lv)) <= 1e-10 * abs(float(lv))
    np.testing.assert_allclose(gf, [float(g["K"]), float(g["D"])], rtol=1e-10)
