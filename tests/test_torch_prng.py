"""The port's threefry keys and draws against jax.random (x64 on, as in every
test process here).

Bits, keys and uniforms must match exactly.  Normals go through each
framework's own erfinv, which differ: by at most a few ulp over most of the
range and by up to ~100 ulp (float32) in the tails |z| > 3.5, where u is
within a few ulp of +-1.  Hence the tolerances: relative 1e-5 (float32) and
1e-11 (float64) per draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import path_keys as jax_path_keys
from repro_torch.core import prng
from repro_torch.core.sdeint import path_keys

NORMAL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-11}
JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _tkey(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5, 2**32 - 1, 2**40 + 7])
def test_prngkey_words(seed):
    assert (np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
            == _np(prng.PRNGKey(seed, device="cpu"))).all()


@pytest.mark.parametrize("data", [0, 1, 7, 12345, 2**31 - 1, 2**32 - 1])
def test_fold_in_exact(data):
    k = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.fold_in(k, data)).astype(np.int64)
    assert (want == _np(prng.fold_in(_tkey(k), data))).all()


@pytest.mark.parametrize("num", [1, 2, 5])
def test_split_exact(num):
    k = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.split(k, num)).astype(np.int64)
    assert (want == _np(prng.split(_tkey(k), num))).all()


def test_batched_key_ops_equal_per_key():
    keys = prng.split(prng.PRNGKey(5, device="cpu"), 4)
    data = torch.arange(3).reshape(3, 1)
    batched = prng.fold_in(keys, data)                       # (3, 4, 2)
    for i in range(3):
        for j in range(4):
            assert torch.equal(batched[i, j], prng.fold_in(keys[j], i))
    sp = prng.split(keys, 3)                                  # (4, 3, 2)
    assert torch.equal(sp[2], prng.split(keys[2], 3))
    nb = prng.normal(keys, (5,))
    assert torch.equal(nb[1], prng.normal(keys[1], (5,)))


@pytest.mark.parametrize("shape", [(), (3,), (4, 5), (1000,)])
@pytest.mark.parametrize("width", [32, 64])
def test_random_bits_exact(shape, width):
    k = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32 if width == 32
                                      else jnp.uint64))
    got = _np(prng.random_bits(_tkey(k), shape, width))
    assert (want.astype(np.uint64) == got.astype(np.uint64)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(), (7,), (3, 16), (4096,)])
@pytest.mark.parametrize("bounds", ["unit", "normal"])
def test_uniform_exact(dtype, shape, bounds):
    """Exact on [0, 1) and on the bounds normal() draws from, where the
    scale is 2 and exact; for other bounds XLA contracts the scale-and-shift
    into an FMA and results may differ by one rounding."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = 0.0 if bounds == "unit" else float(np.nextafter(np_dtype(-1), np_dtype(0)))
    k = jax.random.PRNGKey(21)
    want = np.asarray(jax.random.uniform(k, shape, JNP[dtype], lo, 1.0))
    got = _np(prng.uniform(_tkey(k), shape, dtype, lo, 1.0))
    assert want.dtype == got.dtype and (want == got).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(), (16,), (64, 16), (20000,)])
def test_normal_within_erfinv_ulps(dtype, shape):
    k = jax.random.PRNGKey(4)
    want = np.asarray(jax.random.normal(k, shape, JNP[dtype]))
    got = _np(prng.normal(_tkey(k), shape, dtype))
    assert want.dtype == got.dtype
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL[dtype], atol=0)


@pytest.mark.parametrize("n_paths", [1, 8, 37])
def test_path_keys_exact(n_paths):
    k = jax.random.PRNGKey(17)
    want = np.asarray(jax_path_keys(k, n_paths)).astype(np.int64)
    assert (want == _np(path_keys(_tkey(k), n_paths))).all()


def test_draw_dtype_rejected():
    with pytest.raises(ValueError, match="float32 and float64"):
        prng.normal(prng.PRNGKey(0, device="cpu"), (2,), torch.float16)
