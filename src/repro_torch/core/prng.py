"""Threefry-2x32 keys and normal draws in torch integer ops.

The counterpart of the slice of ``jax.random`` the solve stack uses
(``PRNGKey``, ``fold_in``, ``split``, ``normal``), bit-exact to jax's
threefry2x32 implementation with ``jax_threefry_partitionable=True`` (the
default of current jax):

* a key is a ``(..., 2)`` int64 tensor holding two uint32 words; leading
  axes batch independent keys (the port writes out the batch axis where the
  reference vmaps);
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)``; ``split(key, n)[i]``
  hashes ``(0, i)`` (the same words, under the partitionable layout);
* ``normal(key, shape)`` hashes the 64-bit iota over ``shape`` and maps the
  bits to a uniform on ``[nextafter(-1, 0), 1)`` exactly as jax does, then
  applies ``sqrt(2) * erfinv(u)``.  Bits and uniforms are exact; torch's and
  XLA's ``erfinv`` differ, so normals agree to a few ulp over most of the
  range and to ~1e-5 (float32) / 1e-11 (float64) relative in the far tails.

uint32 arithmetic is done in int64 with ``& 0xFFFFFFFF`` after every add;
shifted words stay below 2**62, so nothing overflows.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["PRNGKey", "fold_in", "split", "threefry2x32", "random_bits",
           "uniform", "normal"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x0, x1)``
    under key words ``(k1, k2)``; all arguments broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + k1) & _M32
    x1 = (x1 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, *, device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """The key of integer ``seed``: its 64-bit pattern as ``(hi, lo)`` words,
    as ``jax.random.PRNGKey`` builds it.  The words are filled in on the
    device (no host-to-device copy, so no wait on queued device work)."""
    s = int(seed) % (1 << 64)
    key = torch.full((2,), s >> 32, dtype=torch.int64,
                     device=resolve_device(device))
    key[1].fill_(s & _M32)
    return key


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a key batch: ``data`` (an int or an
    integer tensor) broadcasts against ``key.shape[:-1]``."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), int(data) & _M32, dtype=torch.int64,
                          device=key.device)
    data = data.to(torch.int64) & _M32
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([o0, o1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` keys per input key, on a new axis
    before the key words (``key.shape[:-1] + (num, 2)``)."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, idx)
    return torch.stack([o0, o1], dim=-1)


def _bit_words(key: torch.Tensor, shape: Sequence[int]):
    """The two hash words over the iota of ``shape``, per key: each of shape
    ``key.shape[:-1] + shape``."""
    size = math.prod(shape)
    if size >= 1 << 32:
        raise ValueError(f"random draw of {size} elements per key exceeds 2**32")
    idx = torch.arange(size, dtype=torch.int64, device=key.device)
    w0, w1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, idx)
    out_shape = tuple(key.shape[:-1]) + tuple(shape)
    return w0.reshape(out_shape), w1.reshape(out_shape)


def random_bits(key: torch.Tensor, shape: Sequence[int], bit_width: int = 32) -> torch.Tensor:
    """``jax.random.bits`` for 32- or 64-bit words, as int64.  64-bit words
    above 2**63 wrap to negative int64 values (same bit pattern)."""
    w0, w1 = _bit_words(key, shape)
    if bit_width == 32:
        return w0 ^ w1
    if bit_width == 64:
        return (w0 << 32) | w1
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


_FLOAT = {
    torch.float32: (np.float32, torch.int32, 9, 0x3F800000),
    torch.float64: (np.float64, torch.int64, 12, 0x3FF0000000000000),
}


def _unit_floats(key, shape, dtype):
    """Floats in [0, 1) from the top mantissa bits of each draw."""
    if dtype not in _FLOAT:
        raise ValueError(f"draws support float32 and float64, got {dtype}")
    _, int_dtype, shift, one_bits = _FLOAT[dtype]
    w0, w1 = _bit_words(key, shape)
    if dtype == torch.float32:
        mant = (w0 ^ w1) >> shift
    else:
        mant = (w0 << 20) | (w1 >> 12)  # top 52 of the 64-bit word w0:w1
    return (mant | one_bits).to(int_dtype).view(dtype) - 1.0


def uniform(key, shape, dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` on ``[minval, maxval)``: bit-exact where the
    scale ``maxval - minval`` is a power of two (``[0, 1)`` and the bounds
    :func:`normal` uses); elsewhere XLA may contract the scale-and-shift into
    an FMA and differ by one rounding."""
    np_dtype = _FLOAT[dtype][0] if dtype in _FLOAT else None
    floats = _unit_floats(key, shape, dtype)
    lo = np_dtype(minval)
    scale = np_dtype(maxval) - lo  # rounded in the draw dtype, as jax does
    return torch.clamp_min(floats * float(scale) + float(lo), float(lo))


def normal(key, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)``, ``u`` uniform on
    ``[nextafter(-1, 0), 1)``; shape ``key.shape[:-1] + shape``."""
    np_dtype = _FLOAT[dtype][0] if dtype in _FLOAT else None
    if np_dtype is None:
        raise ValueError(f"draws support float32 and float64, got {dtype}")
    lo = np.nextafter(np_dtype(-1.0), np_dtype(0.0))
    u = uniform(key, shape, dtype, float(lo), 1.0)
    return torch.erfinv(u) * float(np_dtype(np.sqrt(2.0)))
