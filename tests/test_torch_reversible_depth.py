"""EES(2,5) over residual depth with the reversible adjoint
(``repro_torch.models.reversible``) against the reference, on the CPU.

The reference's own tests (``tests/test_substrate.py``: the reversible
adjoint's gradients match the full adjoint's at rtol 1e-4, and a step of
0.01 approaches Euler at atol 1e-4) run on the port; the port is held to
the reference on the toy block in float64 (1e-10 relative) and on
``olmo-1b``'s smoke block (attention + MLP, weights carried with
``lm_params_from_jax``) in float32 at the reference's limits (rtol 2e-4 /
atol 1e-6, the atol scaled by each array's max|.|: the state reaches ~16
there); and ``LiveBytes`` counts the backward's live tensor bytes: the
reversible peak flat in depth where the full adjoint's grows with it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import ModelOptions as JModelOptions
from repro.models import init_params as jinit_params
from repro.models.layers import attn_block as jattn_block
from repro.models.layers import mlp_block as jmlp_block
from repro.models.reversible import ees_depth_solve as jees_depth_solve
from repro.models.reversible import euler_depth_solve as jeuler_depth_solve
from repro_torch.benchmarks.step_memory import LiveBytes
from repro_torch.configs import get_arch
from repro_torch.models import ModelOptions, lm_params_from_jax, reversible
from repro_torch.models.layers import attn_block, mlp_block
from repro_torch.models.reversible import ees_depth_solve, euler_depth_solve

L, D = 6, 8


def _toy(dtype=np.float64, n_layers=L, d=D, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    w = 0.5 * rng.normal(size=(n_layers, d, d)).astype(dtype)
    y0 = rng.normal(size=(rows, d)).astype(dtype)
    return w, y0


def _tblock(lp, y):
    return torch.tanh(y @ lp["w"]) * 0.1


def _jblock(lp, y):
    return jnp.tanh(y @ lp["w"]) * 0.1


def _tlayers(w):
    return [{"w": torch.tensor(w[i], requires_grad=True)} for i in range(w.shape[0])]


def _tgrads(w, y0, adjoint, step=1.0):
    layers = _tlayers(w)
    y = ees_depth_solve(_tblock, layers, torch.tensor(y0), step=step, adjoint=adjoint)
    (y ** 2).sum().backward()
    return y.detach().numpy(), np.stack([lp["w"].grad.numpy() for lp in layers])


def test_module_exports():
    assert reversible.ees_depth_solve is ees_depth_solve
    assert reversible.__all__ == ["ees_depth_solve", "euler_depth_solve"]
    with pytest.raises(ValueError):
        ees_depth_solve(_tblock, _tlayers(_toy()[0]), torch.zeros(2, D), adjoint="bogus")


def test_reversible_matches_full():
    w, y0 = _toy()
    _, gf = _tgrads(w, y0, "full")
    _, gr = _tgrads(w, y0, "reversible")
    np.testing.assert_allclose(gf, gr, rtol=1e-4, atol=1e-7)


def test_small_step_approaches_euler():
    w, y0 = _toy()
    ye = euler_depth_solve(_tblock, _tlayers(w), torch.tensor(y0), step=0.01)
    ys = ees_depth_solve(_tblock, _tlayers(w), torch.tensor(y0), step=0.01, adjoint="full")
    np.testing.assert_allclose(ye.detach().numpy(), ys.detach().numpy(), atol=1e-4)


@pytest.mark.parametrize("adjoint", ["full", "reversible"])
def test_toy_block_matches_reference_in_float64(adjoint):
    w, y0 = _toy()

    def jloss(w):
        y = jees_depth_solve(_jblock, {"w": w}, jnp.asarray(y0), step=1.0, adjoint=adjoint)
        return jnp.sum(y ** 2), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w))
    y, g = _tgrads(w, y0, adjoint)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-10, atol=1e-12)
    je = jeuler_depth_solve(_jblock, {"w": jnp.asarray(w)}, jnp.asarray(y0), step=0.5)
    te = euler_depth_solve(_tblock, _tlayers(w), torch.tensor(y0), step=0.5)
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(je), rtol=1e-12)


@pytest.fixture(scope="module")
def olmo():
    arch = "olmo-1b"
    jcfg = jget_arch(arch).smoke()
    jparams = jax.jit(jinit_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    return get_arch(arch).smoke(), jcfg, jparams


def test_olmo_block_matches_reference_in_float32(olmo):
    """``examples/train_lm_ees_residual.py``'s block (attention + MLP of the
    running state) over ``olmo-1b``'s smoke layers, reversible adjoint."""
    cfg, jcfg, jparams = olmo
    rng = np.random.default_rng(5)
    h0 = (rng.normal(size=(2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    ct = rng.normal(size=h0.shape).astype(np.float32)

    def jblock(lp, h):
        a = jattn_block(jcfg, lp["attn"], h, JModelOptions())
        return a + jmlp_block(jcfg, lp["mlp"], h + a, JModelOptions())

    def tblock(lp, h):
        a = attn_block(cfg, lp["attn"], h, ModelOptions())
        return a + mlp_block(cfg, lp["mlp"], h + a, ModelOptions())

    jy, vjp = jax.vjp(lambda layers, h: jees_depth_solve(jblock, layers, h, step=1.0),
                      jparams["layers"], jnp.asarray(h0))
    jg_layers, jg_h = vjp(jnp.asarray(ct))
    layers = lm_params_from_jax(jparams, device="cpu").layers
    h = torch.tensor(h0, requires_grad=True)
    y = ees_depth_solve(tblock, layers, h, step=1.0)
    y.backward(torch.from_numpy(ct))
    def close(got, want, name=""):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)

    close(y.detach().numpy(), jy)
    close(h.grad.numpy(), jg_h)
    for i, layer in enumerate(layers):
        for block, sub in layer.items():
            for k, p in sub.items():
                close(p.grad.numpy(), jg_layers[block][k][i], f"{i}.{block}.{k}")


def _backward_peak(n_layers, adjoint):
    """Peak live tensor bytes of a forward and backward above what the
    backward leaves alive (the output and the parameters' gradients)."""
    w, y0 = _toy(np.float32, n_layers=n_layers, d=64, rows=256, seed=1)
    layers = _tlayers(w)
    with LiveBytes() as live:
        y = ees_depth_solve(_tblock, layers, torch.tensor(y0), adjoint=adjoint)
        (y ** 2).sum().backward()
        return live.peak - live.live


def test_reversible_backward_memory_is_flat_in_depth():
    """At 4, 8 and 16 layers: the reversible adjoint stores no per-layer
    activation, so its peak above the gradients is the same at every depth;
    the full adjoint keeps every stage of every layer, so its peak grows
    with depth (at least 3x from 4 to 16 layers)."""
    rev = [_backward_peak(n, "reversible") for n in (4, 8, 16)]
    full = [_backward_peak(n, "full") for n in (4, 8, 16)]
    assert rev[2] <= 1.1 * rev[0] and rev[1] <= 1.1 * rev[0]
    assert full[2] >= 3 * full[0] and full[0] < full[1] < full[2]
    assert full[0] > rev[0]
