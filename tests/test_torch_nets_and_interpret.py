"""The reference's functional nets and interpret hooks in the port.

``linear_apply`` / ``mlp_apply`` (with ``final_activation``) against
``repro.nsde.nets`` on the same weights (float64, 1e-12), on parameter dicts
and on the port's modules; ``MLP(final_activation=...)`` equals
``mlp_apply``.  ``interpret=True`` and ``force_interpret()`` run every fused
step op and the Williamson 2N update through its plain twin: bitwise the
twin's result, forward and backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nsde import nets as jnets
from repro_torch.kernels.sde_step import force_interpret, ops, ref
from repro_torch.kernels.williamson2n import williamson2n_update
from repro_torch.kernels.williamson2n.ref import williamson2n_ref
from repro_torch.nsde import MLP, Linear, linear_apply, mlp_apply, lipswish

SIZES = (3, 8, 8, 2)


@pytest.fixture(scope="module")
def weights():
    layers = jnets.init_mlp(jax.random.PRNGKey(4), SIZES, jnp.float64)
    x = np.random.default_rng(0).normal(size=(5, SIZES[0]))
    tl = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()} for p in layers]
    return layers, tl, x


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def test_linear_apply_equals_reference(weights):
    layers, tl, x = weights
    want = jnets.linear_apply(layers[0], jnp.asarray(x))
    _close(linear_apply(tl[0], torch.from_numpy(x)), want)
    _close(linear_apply(Linear(tl[0]["w"], tl[0]["b"]), torch.from_numpy(x)), want)


@pytest.mark.parametrize("final", [None, "tanh", "softplus"])
def test_mlp_apply_equals_reference(weights, final):
    layers, tl, x = weights
    jfin = {None: None, "tanh": jnp.tanh, "softplus": jax.nn.softplus}[final]
    tfin = {None: None, "tanh": torch.tanh,
            "softplus": torch.nn.functional.softplus}[final]
    want = jnets.mlp_apply(layers, jnp.asarray(x), final_activation=jfin)
    _close(mlp_apply(tl, torch.from_numpy(x), final_activation=tfin), want)
    mlp = MLP([Linear(p["w"], p["b"]) for p in tl], final_activation=tfin)
    assert torch.equal(mlp(torch.from_numpy(x)),
                       mlp_apply(tl, torch.from_numpy(x), final_activation=tfin))
    _close(lipswish(torch.from_numpy(x)), jnets.lipswish(jnp.asarray(x)))


def _leaves(n=257, m=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64,  # noqa: E731
                               requires_grad=True)
    return r(n), r(n), r(n), r(n), r(n), r(n, m), r(n, m), r(m)


def _grads(out, inputs):
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o * (i + 1)).sum() for i, o in enumerate(outs))
    return torch.autograd.grad(loss, inputs, allow_unused=True)


CASES = {
    "increment_diag": lambda d, y, f, g, w, G, W, _, **kw: (
        ops.fused_increment(f, g, w, 0.1, noise="diagonal", **kw), (f, g, w)),
    "increment_pre": lambda d, y, f, g, w, G, W, _, **kw: (
        ops.fused_increment(f, None, w, 0.1, noise="prediffused", **kw), (f, w)),
    "increment_general": lambda d, y, f, g, w, G, W, m, **kw: (
        ops.fused_increment(f[:, None].expand(-1, 2).contiguous(),
                            G[:, None].expand(-1, 2, -1), W, 0.1,
                            noise="general", **kw), (f, G, W)),
    "ws_stage_diag": lambda d, y, f, g, w, G, W, _, **kw: (
        ops.fused_ws_stage(d, y, f, g, w, 0.1, a=-0.5, b=0.7, noise="diagonal",
                           **kw), (d, y, f, g, w)),
    "ws_stage_pre": lambda d, y, f, g, w, G, W, _, **kw: (
        ops.fused_ws_stage(d, y, f, None, w, 0.1, a=-0.5, b=0.7,
                           noise="prediffused", **kw), (d, y, f, w)),
    "ws_stage_general": lambda d, y, f, g, w, G, W, _, **kw: (
        ops.fused_ws_stage(d[:, None].expand(-1, 2), y[:, None].expand(-1, 2),
                           f[:, None].expand(-1, 2), G[:, None].expand(-1, 2, -1),
                           W, 0.1, a=-0.5, b=0.7, noise="general", **kw),
        (d, y, f, G, W)),
    "axpy_chain": lambda d, y, f, g, w, G, W, _, **kw: (
        ops.fused_axpy_chain(y, [f, g, w], [0.5, -1.25, 2.0], **kw), (y, f, g, w)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_interpret_runs_the_twin_bitwise(monkeypatch, name):
    """``interpret=True`` and ``force_interpret()`` never reach a kernel
    wrapper (each is replaced by a trap here) and equal the default CPU
    route, which is the twin, bitwise, forward and backward."""
    want_out, want_in = CASES[name](*_leaves())
    want = (want_out, _grads(want_out, want_in))

    def trap(*a, **kw):
        raise AssertionError("interpret mode reached a kernel wrapper")

    for wrapper in ("increment_diag", "increment_pre", "increment_general",
                    "ws_stage_diag", "ws_stage_diag_bwd", "ws_stage_pre",
                    "ws_stage_general", "axpy_chain"):
        monkeypatch.setattr(ops._k, wrapper, trap)
    for mode in ("flag", "context"):
        if mode == "flag":
            out, inputs = CASES[name](*_leaves(), interpret=True)
        else:
            with force_interpret():
                out, inputs = CASES[name](*_leaves())
        got = (out, _grads(out, inputs))
        for g, w in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(g, w), (name, mode)
    assert not ops._FORCE_INTERPRET


def test_interpret_twin_names_match_the_wrappers():
    for name in ("increment_diag", "increment_pre", "increment_general",
                 "ws_stage_diag", "ws_stage_diag_bwd", "ws_stage_pre",
                 "ws_stage_general", "axpy_chain"):
        assert callable(getattr(ops._TWINS, name))
        assert callable(getattr(ref, f"{name}_ref"))


def test_williamson2n_interpret_is_the_twin(monkeypatch):
    d, k, y = _leaves()[:3]
    want = williamson2n_ref(d, k, y, -0.5, 0.7)
    monkeypatch.setattr("repro_torch.kernels.williamson2n.ops.williamson2n",
                        lambda *a, **kw: pytest.fail("reached the kernel wrapper"))
    got = williamson2n_update(d, k, y, -0.5, 0.7, interpret=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    gd = _grads(got, (d, k, y))
    assert torch.equal(gd[2], torch.full_like(y, 2.0))
