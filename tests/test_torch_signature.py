"""The port's truncated signature MMD (``repro_torch.nsde.signature_mmd``)
against the reference's (``repro.nsde.losses.signature_mmd``).

Float64 in this process: the value and its gradient with respect to the
generated paths, for ``(batch, T)`` and ``(batch, T, d)`` inputs, with
``times`` given and defaulted, at rtol 1e-12 (both sum the same iterated
products; they differ in summation order, the batched ``einsum`` of the
port against the reference's per-path ``vmap``, and in ``linspace``'s last
bit).  The per-path signature is also held against the reference's
``_signature_l3`` path by path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nsde import losses as jlosses
from repro_torch.nsde import losses, signature_mmd

RTOL = 1e-12


def _paths(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).cumsum(axis=1) * 0.3


@pytest.mark.parametrize("shape", [(12, 7, 1), (9, 5, 2), (6, 4, 3)])
def test_signature_l3_equals_reference(shape):
    x = _paths(shape, 0)
    got = losses._signature_l3(torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(jlosses._signature_l3(jnp.asarray(p))) for p in x])
    d = shape[-1]
    assert got.shape == (shape[0], d + d ** 2 + d ** 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("gen_shape, tgt_shape", [
    ((16, 6), (20, 6)), ((8, 5, 2), (11, 5, 2)), ((4, 9, 3), (4, 9, 3))])
@pytest.mark.parametrize("with_times", [False, True])
def test_signature_mmd_and_grad_equal_reference(gen_shape, tgt_shape, with_times):
    gen, tgt = _paths(gen_shape, 1), _paths(tgt_shape, 2)
    times = np.sort(np.random.default_rng(3).uniform(0, 2, gen_shape[1])) \
        if with_times else None
    jt = None if times is None else jnp.asarray(times)
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda g: jlosses.signature_mmd(g, jnp.asarray(tgt), jt)))(jnp.asarray(gen))
    g = torch.from_numpy(gen).requires_grad_()
    tt = None if times is None else torch.from_numpy(times)
    val = signature_mmd(g, torch.from_numpy(tgt), tt)
    (grad,) = torch.autograd.grad(val, g)
    assert val.dtype == torch.float64 and float(want_v) > 0
    np.testing.assert_allclose(float(val.detach()), float(want_v), rtol=RTOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(want_g)).max())


def test_signature_mmd_takes_a_numpy_target_and_is_zero_on_itself():
    gen = torch.from_numpy(_paths((5, 6), 4))
    assert float(signature_mmd(gen, gen.numpy())) == 0.0
    assert float(signature_mmd(gen, _paths((5, 6), 5))) > 0.0
