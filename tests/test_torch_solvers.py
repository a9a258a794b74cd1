"""SDETerm, LowStorageSolver and the registry of the port against the
reference, fed the same increments (float64).

Tolerance: 1e-12 relative.  Both sides run the same 2N recurrence in the
same order; they differ only in the last bits of sin/cos (XLA's and torch's
CPU implementations) and in XLA's FMA contraction.  Within the port, the
kernel route (its CPU twin) equals the plain route bitwise.
"""
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


def test_kernel_routes_still_to_port_raise():
    (_, _), (ty, tw) = _case("general", False)
    sol = treg.get_solver("ees25:use_kernels=True")
    with pytest.raises(ValueError, match="ws_stage_general_2d"):
        sol.step(ts.SDETerm(**_fields("general", "torch")), ty[:3], 0.0, 0.1, tw, 0.7)
    term = ts.SDETerm(**_fields("diagonal", "torch"))
    f, g = term.evals(0.0, ty, 0.7)
    with pytest.raises(ValueError, match="increment_diag_2d"):
        term.combine(f, g, 0.1, ty, use_kernels=True)


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


@pytest.mark.parametrize("name", ["rk4", "reversible_heun", "mcf-rk4", "milstein"])
def test_unported_solvers_fail_with_the_unknown_solver_message(name):
    with pytest.raises(KeyError) as got:
        treg.get_solver(name)
    assert got.value.args[0] == (f"unknown solver {jreg._canon(name)!r}; "
                                 "registered: ees25, ees27")
    assert treg.list_solvers() == ("ees25", "ees27")


def test_solver_objects_match():
    for spec in SCHEMES:
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
