"""SDETerm, the solvers (2N, Butcher, Reversible Heun, MCF) and the registry
of the port against the reference, fed the same increments (float64).

Tolerance: 1e-12 relative.  Both sides run the same recurrences in the
same order; they differ only in the last bits of sin/cos (XLA's and torch's
CPU implementations) and in XLA's FMA contraction.  Within the port, the
kernel route (its CPU twins) equals the plain route bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import registry as jreg
from repro.core import solvers as js
from repro_torch.core import registry as treg
from repro_torch.core import solvers as ts
from repro_torch.core.pytree import tree_leaves

RTOL, ATOL = 1e-12, 1e-14
SCHEMES = ["ees25", "ees27", "ees25:x=0.3"]


def _fields(noise, lib):
    sin, cos = (jnp.sin, jnp.cos) if lib == "jax" else (torch.sin, torch.cos)
    ones = jnp.ones_like if lib == "jax" else torch.ones_like

    def leafwise(fn):
        return lambda t, y, a: (tuple(fn(t, yi, a) for yi in y)
                                if isinstance(y, tuple) else fn(t, y, a))

    drift = leafwise(lambda t, y, a: a * sin(y) - 0.3 * y * t)
    if noise == "none":
        return dict(drift=drift, noise="none")
    if noise == "additive":
        return dict(drift=drift, diffusion=leafwise(lambda t, y, a: 0.3 * ones(y)),
                    noise="additive")
    if noise == "general":
        mix = (jnp.asarray if lib == "jax" else torch.tensor)([1.0, 0.5])
        return dict(drift=drift, noise="general", diffusion=lambda t, y, a:
                    0.1 * cos(y)[..., :, None] * mix)
    return dict(drift=drift, noise=noise,
                diffusion=leafwise(lambda t, y, a: 0.2 + 0.1 * cos(y)))


def _case(noise, tuple_state, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(3,), (2,)] if tuple_state else [(4,)]
    y = [rng.normal(size=s) for s in shapes]
    if noise == "scalar":
        dw = rng.normal() * 0.3
    elif noise == "general":
        dw = rng.normal(size=(2,)) * 0.3
    elif noise == "none":
        dw = None
    else:
        dw = [rng.normal(size=s) * 0.3 for s in shapes]
    pack = (lambda xs, f: tuple(map(f, xs)) if tuple_state else f(xs[0]))

    def conv(f):
        if dw is None or noise in ("scalar", "general"):
            w = None if dw is None else f(np.asarray(dw))
        else:
            w = pack(dw, f)
        return pack(y, f), w

    return conv(jnp.asarray), conv(torch.from_numpy)


def _solvers(spec, use_kernels):
    return (jreg.get_solver(spec, use_kernels=use_kernels),
            treg.get_solver(spec, use_kernels=use_kernels))


def _assert_tree_close(got, want):
    g_leaves = [x.numpy() for x in tree_leaves(got)]
    w_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


CASES = [("diagonal", False), ("diagonal", True), ("additive", False),
         ("scalar", False), ("none", False), ("none", True)]


@pytest.mark.parametrize("spec", SCHEMES)
@pytest.mark.parametrize("noise,tuple_state", CASES)
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("method", ["step", "reverse", "step_with_error"])
def test_low_storage_matches_reference(spec, noise, tuple_state, use_kernels, method):
    (jy, jw), (ty, tw) = _case(noise, tuple_state)
    jsol, tsol = _solvers(spec, use_kernels)
    jterm, tterm = js.SDETerm(**_fields(noise, "jax")), ts.SDETerm(**_fields(noise, "torch"))
    want = getattr(jsol, method)(jterm, jy, 0.3, 0.1, jw, 0.7)
    got = getattr(tsol, method)(tterm, ty, 0.3, 0.1, tw, 0.7)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("spec", SCHEMES)
@pytest.mark.parametrize("noise,tuple_state", CASES)
def test_kernel_route_equals_plain_route_bitwise(spec, noise, tuple_state):
    _, (ty, tw) = _case(noise, tuple_state, seed=1)
    term = ts.SDETerm(**_fields(noise, "torch"))
    plain = treg.get_solver(spec).step_with_error(term, ty, 0.2, 0.05, tw, 0.7)
    fused = treg.get_solver(spec, use_kernels=True).step_with_error(
        term, ty, 0.2, 0.05, tw, 0.7)
    for p, f in zip(tree_leaves(plain), tree_leaves(fused)):
        assert torch.equal(p, f)


@pytest.mark.parametrize("method", ["step", "reverse"])
def test_general_noise_plain_matches_reference(method):
    (jy, jw), (ty, tw) = _case("general", False, seed=2)
    jsol, tsol = _solvers("ees25", False)
    want = getattr(jsol, method)(js.SDETerm(**_fields("general", "jax")),
                                 jy[:3], 0.3, 0.1, jw, 0.7)
    got = getattr(tsol, method)(ts.SDETerm(**_fields("general", "torch")),
                                ty[:3], 0.3, 0.1, tw, 0.7)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("noise,tuple_state", [("general", False), ("diagonal", True)])
def test_kernel_routes_match_reference(noise, tuple_state):
    """``SDETerm.combine(use_kernels=True)`` runs ``increment_general`` /
    ``increment_diag`` (their CPU twins) and the 2N solver the fused stage:
    equal to the reference's fused routes to 1e-12, and to the port's plain
    route bitwise for diagonal noise and to 1e-12 for general noise (its
    kernels sum g@dW left to right, the plain route uses einsum)."""
    (jy, jw), (ty, tw) = _case(noise, tuple_state)
    if noise == "general":
        jy, ty = jy[:3], ty[:3]
    term = ts.SDETerm(**_fields(noise, "torch"))
    jterm = js.SDETerm(**_fields(noise, "jax"))
    f, g = term.evals(0.0, ty, 0.7)
    fused = term.combine(f, g, 0.1, tw, use_kernels=True)
    plain = term.combine(f, g, 0.1, tw)
    for p, k in zip(tree_leaves(plain), tree_leaves(fused)):
        if noise == "diagonal":
            assert torch.equal(p, k)
        else:
            torch.testing.assert_close(k, p, rtol=RTOL, atol=ATOL)
    jf, jg = jterm.evals(0.0, jy, 0.7)
    _assert_tree_close(fused, jterm.combine(jf, jg, 0.1, jw, use_kernels=True))
    sol = treg.get_solver("ees25:use_kernels=True")
    jsol = jreg.get_solver("ees25:use_kernels=True")
    _assert_tree_close(sol.step(term, ty, 0.0, 0.1, tw, 0.7),
                       jsol.step(jterm, jy, 0.0, 0.1, jw, 0.7))


@pytest.mark.parametrize("kwargs", [dict(drift=abs, noise="bogus"),
                                    dict(drift=abs, noise="diagonal"),
                                    dict(drift=abs, noise="scalar")])
def test_sdeterm_validation_messages(kwargs):
    with pytest.raises(ValueError) as want:
        js.SDETerm(**kwargs)
    with pytest.raises(ValueError) as got:
        ts.SDETerm(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["ees25", "EES25", " Ees27 ", "ees25:x=0.3",
                                  "ees25: use_kernels=True, x=0.3",
                                  "ees27:use_kernel=True", "ees25:adaptive"])
def test_spec_grammar_equal(spec):
    assert treg.parse_solver_spec(spec) == jreg.parse_solver_spec(spec)
    assert treg.canonical_spec(spec) == jreg.canonical_spec(spec)
    assert treg.solver_kind(spec) == jreg.solver_kind(spec) == "euclidean"


@pytest.mark.parametrize("spec", ["ees25:bogus=1", "ees27:x=0.3", "ees25:3"])
def test_spec_errors_equal(spec):
    with pytest.raises(ValueError) as want:
        jreg.get_solver(spec)
    with pytest.raises(ValueError) as got:
        treg.get_solver(spec)
    assert str(got.value) == str(want.value)


PORTED = ("ees25", "ees25-butcher", "ees27", "ees27-butcher", "euler", "heun",
          "mcf-euler", "mcf-heun", "mcf-midpoint", "mcf-ralston3", "mcf-rk3",
          "mcf-rk4", "midpoint", "milstein", "ralston3", "reversible-heun", "rk3",
          "rk4", "srk", "strat-milstein")


MANIFOLD = ("cfees25", "cfees25:x=0.3", "cfees27", "geo-em", "cg2", "rkmk2")


@pytest.mark.parametrize("spec", MANIFOLD[:1] + MANIFOLD[2:])
def test_manifold_solvers_match_the_reference(spec):
    """Every manifold spec of the reference resolves to the port's
    counterpart, with the reference's name, costs, reversibility and kind."""
    j, t = jreg.get_solver(spec), treg.get_solver(spec)
    assert (t.name, t.evals_per_step, t.exps_per_step, t.is_reversible) == (
        j.name, j.evals_per_step, j.exps_per_step, j.is_reversible)
    assert treg.solver_kind(spec) == jreg.solver_kind(spec) == "manifold"
    assert treg.canonical_spec(spec) == jreg.canonical_spec(spec)
    assert type(t).__name__ == type(j).__name__


def test_registry_lists_and_unknown_message_equal_the_reference():
    assert treg.list_solvers() == jreg.list_solvers()
    for kind in ("euclidean", "manifold", "other"):
        assert treg.list_solvers(kind=kind) == jreg.list_solvers(kind=kind)
    assert treg.list_solvers(kind="euclidean") == PORTED
    assert treg.list_solvers(kind="manifold") == ("cfees25", "cfees27", "cg2", "geo-em",
                                                  "rkmk2")
    ty = treg.get_solver(MANIFOLD[1])
    jy = jreg.get_solver(MANIFOLD[1])
    assert (ty.name, ty.ls.A, ty.ls.B, ty.ls.c) == (jy.name, jy.ls.A, jy.ls.B, jy.ls.c)
    for name in ("cf-ees", "bogus_solver"):
        with pytest.raises(KeyError) as want:
            jreg.get_solver(name)
        with pytest.raises(KeyError) as got:
            treg.get_solver(name)
        assert got.value.args[0] == want.value.args[0]


def test_solver_objects_match():
    for spec in SCHEMES + list(PORTED[1:]) + ["mcf-rk4:lam=0.9", "ees25-butcher:x=0.3",
                                              "srk:noise='additive'"]:
        j, t = jreg.get_solver(spec), treg.get_solver(spec)
        assert (t.name, t.evals_per_step, t.is_reversible, t.sde_form,
                t.strong_orders) == (j.name, j.evals_per_step, j.is_reversible,
                                     j.sde_form, j.strong_orders)
    assert treg.get_solver("ees25:use_kernel=True").use_kernels
    assert not treg.get_solver("ees25:use_kernel=True", use_kernels=False).use_kernels
    assert not treg.get_solver("ees25").use_kernels
    assert treg.get_solver("ees25:adaptive").adaptive
    obj = treg.get_solver("ees27")
    assert treg.get_solver(obj) is obj
    with pytest.raises(ValueError, match="overrides only apply"):
        treg.get_solver(obj, use_kernels=True)


# -- Butcher, Reversible Heun and MCF -----------------------------------------

OTHER = ["euler", "midpoint", "rk4", "ees25-butcher", "ees27-butcher",
         "reversible-heun", "mcf-euler", "mcf-midpoint", "mcf-rk4:lam=0.9"]
KERNEL_ROUTE = [s for s in OTHER if "butcher" not in s]  # factories without the flag
OTHER_CASES = [("diagonal", False), ("diagonal", True), ("additive", False),
               ("scalar", False), ("none", False)]


@pytest.mark.parametrize("spec", OTHER)
@pytest.mark.parametrize("noise,tuple_state", OTHER_CASES)
@pytest.mark.parametrize("method", ["step", "reverse"])
def test_other_solvers_match_reference(spec, noise, tuple_state, method):
    (jy, jw), (ty, tw) = _case(noise, tuple_state, seed=7)
    jsol, tsol = jreg.get_solver(spec), treg.get_solver(spec)
    jterm, tterm = js.SDETerm(**_fields(noise, "jax")), ts.SDETerm(**_fields(noise, "torch"))
    # the solvers' own initial states (Reversible Heun's evaluates f, g)
    js0, ts0 = jsol.init(jterm, 0.3, jy, 0.7), tsol.init(tterm, 0.3, ty, 0.7)
    want = getattr(jsol, method)(jterm, js0, 0.3, 0.1, jw, 0.7)
    got = getattr(tsol, method)(tterm, ts0, 0.3, 0.1, tw, 0.7)
    _assert_tree_close(got, want)
    _assert_tree_close(tsol.extract(got), jsol.extract(want))


@pytest.mark.parametrize("spec", KERNEL_ROUTE)
@pytest.mark.parametrize("noise,tuple_state", OTHER_CASES)
def test_other_solvers_kernel_route_bitwise(spec, noise, tuple_state):
    """use_kernels=True (increment_diag + axpy_chain twins) == plain, bitwise,
    on step and reverse; and == the reference's fused route to 1e-12."""
    (jy, jw), (ty, tw) = _case(noise, tuple_state, seed=8)
    tterm = ts.SDETerm(**_fields(noise, "torch"))
    plain, fused = treg.get_solver(spec), treg.get_solver(spec, use_kernels=True)
    assert fused.use_kernels and not plain.use_kernels
    s0 = plain.init(tterm, 0.1, ty, 0.7)
    for method in ("step", "reverse"):
        p = getattr(plain, method)(tterm, s0, 0.1, 0.05, tw, 0.7)
        f = getattr(fused, method)(tterm, s0, 0.1, 0.05, tw, 0.7)
        for a, b in zip(tree_leaves(p), tree_leaves(f)):
            assert torch.equal(a, b)
    jsol = jreg.get_solver(spec, use_kernels=True)
    jterm = js.SDETerm(**_fields(noise, "jax"))
    want = jsol.step(jterm, jsol.init(jterm, 0.1, jy, 0.7), 0.1, 0.05, jw, 0.7)
    _assert_tree_close(fused.step(tterm, s0, 0.1, 0.05, tw, 0.7), want)


@pytest.mark.parametrize("spec", ["reversible-heun", "mcf-euler", "mcf-midpoint",
                                  "mcf-rk4"])
def test_algebraic_solvers_reverse_exactly(spec):
    """reverse(step(s)) == s to rounding for the algebraically reversible
    solvers (1e-13 absolute, as the reference's test)."""
    (_, _), (ty, tw) = _case("diagonal", False, seed=9)
    term = ts.SDETerm(**_fields("diagonal", "torch"))
    sol = treg.get_solver(spec, use_kernels=True)
    s0 = sol.init(term, 0.0, ty, 0.7)
    back = sol.reverse(term, sol.step(term, s0, 0.0, 0.1, tw, 0.7), 0.0, 0.1, tw, 0.7)
    for a, b in zip(tree_leaves(back), tree_leaves(s0)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-13)


@pytest.mark.parametrize("spec", ["midpoint", "rk4", "ees25-butcher"])
def test_butcher_step_with_error_matches_reference(spec):
    (jy, jw), (ty, tw) = _case("diagonal", False, seed=10)
    jsol, tsol = jreg.get_solver(spec), treg.get_solver(spec)
    want = jsol.step_with_error(js.SDETerm(**_fields("diagonal", "jax")), jy, 0.3, 0.1, jw, 0.7)
    got = tsol.step_with_error(ts.SDETerm(**_fields("diagonal", "torch")), ty, 0.3, 0.1, tw, 0.7)
    _assert_tree_close(got, want)
    with pytest.raises(ValueError) as w:
        jreg.get_solver("euler").step_with_error(None, jy, 0.0, 0.1, jw, None)
    with pytest.raises(ValueError) as g:
        treg.get_solver("euler").step_with_error(None, ty, 0.0, 0.1, tw, None)
    assert str(g.value) == str(w.value)


def test_tableaux_equal_reference():
    from repro.core import tableaux as jt
    from repro_torch.core import tableaux as tt
    fields = dataclasses.astuple
    for name in ("euler", "midpoint", "heun", "ralston3", "rk3", "rk4"):
        assert fields(getattr(tt, name)) == fields(getattr(jt, name))
    for x in (0.1, 0.3):
        assert fields(tt.ees25_tableau(x)) == fields(jt.ees25_tableau(x))
    got, want = tt.ees27_tableau(), jt.ees27_tableau()
    assert (got.name, got.order, got.sym_order) == (want.name, want.order, want.sym_order)
    np.testing.assert_allclose(got.a, want.a, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got.b, want.b, rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="admissible"):
        tt.ees25_tableau(0.5)


# -- Milstein, SRA1, select_solver, stability -----------------------------------

MILSTEIN_CASES = [("diagonal", False), ("diagonal", True), ("additive", False),
                  ("scalar", False), ("none", False)]


@pytest.mark.parametrize("spec", ["milstein", "strat-milstein", "milstein:use_kernels=True"])
@pytest.mark.parametrize("noise,tuple_state", MILSTEIN_CASES)
@pytest.mark.parametrize("method", ["step", "reverse", "step_with_error"])
def test_milstein_matches_reference(spec, noise, tuple_state, method):
    """Fed the reference's own increments; the correction's jvp
    (``torch.func.jvp`` for ``jax.jvp``) included (1e-12 relative)."""
    (jy, jw), (ty, tw) = _case(noise, tuple_state, seed=21)
    jsol, tsol = jreg.get_solver(spec), treg.get_solver(spec)
    jterm, tterm = js.SDETerm(**_fields(noise, "jax")), ts.SDETerm(**_fields(noise, "torch"))
    want = getattr(jsol, method)(jterm, jsol.init(jterm, 0.3, jy, 0.7), 0.3, 0.1, jw, 0.7)
    got = getattr(tsol, method)(tterm, tsol.init(tterm, 0.3, ty, 0.7), 0.3, 0.1, tw, 0.7)
    _assert_tree_close(got, want)


def test_milstein_kernel_route_is_bitwise_plain():
    (_, _), (ty, tw) = _case("diagonal", True, seed=22)
    term = ts.SDETerm(**_fields("diagonal", "torch"))
    plain, fused = treg.get_solver("milstein"), treg.get_solver("milstein:use_kernels=True")
    for a, b in zip(tree_leaves(plain.step(term, ty, 0.1, 0.05, tw, 0.7)),
                    tree_leaves(fused.step(term, ty, 0.1, 0.05, tw, 0.7))):
        assert torch.equal(a, b)


def _levy_case(tuple_state, seed):
    rng = np.random.default_rng(seed)
    shapes = [(3,), (2,)] if tuple_state else [(4,)]
    y, dw, dh = ([rng.normal(size=s) * sc for s in shapes] for sc in (1.0, 0.3, 0.1))
    pack = (lambda xs, f: tuple(map(f, xs)) if tuple_state else f(xs[0]))
    return ((pack(y, jnp.asarray), (pack(dw, jnp.asarray), pack(dh, jnp.asarray))),
            (pack(y, torch.from_numpy), (pack(dw, torch.from_numpy),
                                         pack(dh, torch.from_numpy))))


@pytest.mark.parametrize("tuple_state", [False, True])
@pytest.mark.parametrize("method", ["step", "reverse", "step_with_error"])
def test_srk_matches_reference(tuple_state, method):
    """SRA1 fed the reference's own ``(dW, dH)`` pairs (1e-12 relative)."""
    (jy, jpair), (ty, tpair) = _levy_case(tuple_state, seed=23)
    jsol, tsol = jreg.get_solver("srk"), treg.get_solver("srk")
    jterm = js.SDETerm(**_fields("additive", "jax"))
    tterm = ts.SDETerm(**_fields("additive", "torch"))
    want = getattr(jsol, method)(jterm, jsol.init(jterm, 0.3, jy, 0.7), 0.3, 0.1, jpair, 0.7)
    got = getattr(tsol, method)(tterm, tsol.init(tterm, 0.3, ty, 0.7), 0.3, 0.1, tpair, 0.7)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("case", ["milstein general", "milstein form", "srk init",
                                  "srk noise"])
def test_noise_specialised_errors_equal(case):
    def run(reg, sol_mod, lib):
        if case == "milstein general":
            return reg.get_solver("milstein").init(
                sol_mod.SDETerm(**_fields("general", lib)), 0.0, None, None)
        if case == "milstein form":
            return sol_mod.Milstein(form="bogus")
        if case == "srk init":
            return reg.get_solver("srk").init(
                sol_mod.SDETerm(**_fields("diagonal", lib)), 0.0, None, None)
        return reg.get_solver("srk:noise='diagonal'")

    with pytest.raises(ValueError) as want:
        run(jreg, js, "jax")
    with pytest.raises(ValueError) as got:
        run(treg, ts, "torch")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("noise", ["none", "diagonal", "additive", "scalar", "general"])
def test_select_solver_decision_table(noise):
    for stiffness in (0.0, -0.5, 10.0, 50.0, 100.0, 200.0, -400.0):
        for dt in (None, 0.001, 0.015625, 0.02, 0.05, 0.1):
            assert treg.select_solver(noise=noise, stiffness=stiffness, dt=dt) \
                == jreg.select_solver(noise=noise, stiffness=stiffness, dt=dt)
    assert treg.select_solver(noise) == jreg.select_solver(noise)


def test_select_solver_error_message():
    with pytest.raises(ValueError) as want:
        jreg.select_solver(noise="bogus")
    with pytest.raises(ValueError) as got:
        treg.select_solver(noise="bogus")
    assert str(got.value) == str(want.value)
    # every spec it returns resolves in the port's registry
    for noise in ("none", "diagonal", "additive", "scalar", "general"):
        for stiffness in (0.0, 100.0, 200.0):
            treg.get_solver(treg.select_solver(noise, stiffness, dt=0.02))


@pytest.mark.parametrize("tab", ["euler", "midpoint", "rk4", "ees25", "ees27"])
def test_stability_matches_reference(tab):
    from repro.core import stability as jstab
    from repro.core import tableaux as jt
    from repro_torch.core import stability as tstab
    from repro_torch.core import tableaux as tt
    pick = {"ees25": lambda m: m.ees25_tableau(), "ees27": lambda m: m.ees27_tableau()}
    jtab = pick.get(tab, lambda m: getattr(m, tab))(jt)
    ttab = pick.get(tab, lambda m: getattr(m, tab))(tt)
    np.testing.assert_allclose(tt.stability_poly(ttab), jt.stability_poly(jtab),
                               rtol=1e-14, atol=1e-15)
    rho = np.array([-3.0, -1.0 + 0.5j, 0.25j, -2.5])
    np.testing.assert_allclose(tstab.stability_function(ttab)(rho),
                               jstab.stability_function(jtab)(rho), rtol=1e-13)
    assert (tstab.is_linearly_stable(ttab, rho)
            == jstab.is_linearly_stable(jtab, rho)).all()
    for lam, mu, h in ((-1.0, 0.5, 0.5), (-4.0, 1.0, 0.25), (-0.2, 2.0, 1.0)):
        assert tstab.mean_square_factor(ttab, lam, mu, h) == pytest.approx(
            jstab.mean_square_factor(jtab, lam, mu, h), rel=1e-13)
    grid = tstab.ms_stability_region(ttab, [-3.0, -1.0, -0.1], [0.0, 0.5, 2.0])
    assert (grid == jstab.ms_stability_region(jtab, [-3.0, -1.0, -0.1],
                                              [0.0, 0.5, 2.0])).all()
