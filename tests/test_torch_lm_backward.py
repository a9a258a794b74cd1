"""The backward twins of the LM kernels against the reference, on the CPU.

The reference has no backward kernel: it trains through ``attention_ref``
and ``ssd_chunked_ref`` under ``jax.grad``.  ``attention_bwd_ref`` and
``ssd_bwd_ref``, which the port's backward kernels mirror
(``csrc/flash_attention_bwd.cu``, ``csrc/ssd_scan_bwd.cu``), are held to
that gradient and to ``torch.autograd`` through the port's forward twins, at
the reference's kernel-test shapes (GQA, causal and not, a scale of 0.5, the
SSD's decay extremes).  The autograd Functions around the two kernels run
the twins on CPU tensors and are held to the same gradients.  The kernels
themselves are held to the twins on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3).

Limits: attention computes in float32 in both frameworks, so its gradients
agree to float32 rounding, held at 1e-5 of each gradient's max|.|; the SSD
runs in float64 (x64 is on in these tests), held at 1e-10 of each
gradient's max|.|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.ssd_scan.ref import ssd_chunked_ref as jssd_chunked_ref
from repro_torch.kernels import FLASH_ATTENTION_BWD, SSD_SCAN_BWD
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd
from repro_torch.kernels.flash_attention.ops import _FlashAttention
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.ssd_scan.ops import _SSDScan
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_chunked_ref, ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_bwd

ATTN_REL = 1e-5
SSD_REL = 1e-10

# (b, hq, hkv, s, d, causal, sm_scale): the reference's kernel tests (MQA,
# GQA group 4, bidirectional, sm_scale 0.5), qwen3-1.7b's 16/8 heads, a
# ragged length and odd head dims
ATTN_CASES = [(2, 4, 2, 256, 64, True, None), (1, 8, 1, 128, 128, True, None),
              (2, 2, 2, 256, 64, False, None), (1, 4, 4, 384, 32, True, None),
              (1, 16, 4, 256, 64, True, None), (1, 2, 2, 128, 64, True, 0.5),
              (1, 16, 8, 64, 128, True, None), (2, 4, 2, 200, 112, False, None),
              (1, 4, 2, 130, 1, True, None), (1, 4, 2, 129, 127, False, None)]
# (b, l, h, dh, ds, chunk): the reference's tests; None marks the decay extremes
SSD_CASES = [(2, 128, 3, 16, 32, 32), (1, 256, 2, 64, 128, 128), (2, 64, 4, 8, 16, 64),
             (1, 512, 1, 32, 64, 64), None]


def _attn_inputs(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, s, d)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    return q, k, v, do


def _assert_rel(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (name, np.abs(got - want).max(), scale)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jit_attention_grads(q, k, v, do, causal, scale):
    _, vjp = jax.vjp(lambda q, k, v: jattention_ref(q, k, v, causal=causal, sm_scale=scale),
                     q, k, v)
    return vjp(do)


def _jax_attention_grads(q, k, v, do, causal, scale):
    return _jit_attention_grads(*map(jnp.asarray, (q, k, v, do)), causal, scale)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,scale", ATTN_CASES)
def test_attention_bwd_twin_matches_jax_grad_and_autograd(b, hq, hkv, s, d, causal, scale):
    q, k, v, do = _attn_inputs(b, hq, hkv, s, d, seed=s + hq + d)
    want = _jax_attention_grads(q, k, v, do, causal, scale)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out = attention_ref(tq, tk, tv, causal=causal, sm_scale=scale)
    got = attention_bwd_ref(tq, tk, tv, out, tdo, causal=causal, sm_scale=scale)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(attention_ref(*leaves, causal=causal, sm_scale=scale),
                               leaves, tdo)
    for name, g, w, a in zip("qkv", got, want, auto):
        assert g.dtype == torch.float32 and g.shape == a.shape
        _assert_rel(g, w, ATTN_REL, "d" + name)
        _assert_rel(g, a, ATTN_REL, "d" + name)


def test_attention_bwd_twin_in_bf16_rounds_the_float32_gradient():
    q, k, v, do = _attn_inputs(1, 4, 2, 128, 64, seed=3)
    t16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    out = attention_ref(*t16[:3], causal=True)
    got = attention_bwd_ref(*t16[:3], out, t16[3], causal=True)
    want = attention_bwd_ref(*(t.float() for t in t16[:3]), out.float(), t16[3].float(),
                             causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,scale", ATTN_CASES[:6])
def test_flash_attention_function_on_the_cpu_runs_the_twin(b, hq, hkv, s, d, causal, scale):
    q, k, v, do = _attn_inputs(b, hq, hkv, s, d, seed=s + hq + d)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = FLASH_ATTENTION_BWD.launches
    out = _FlashAttention.apply(*leaves, causal, scale)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert FLASH_ATTENTION_BWD.launches == before
    want = attention_bwd_ref(*(t.detach() for t in leaves), out.detach(),
                             torch.from_numpy(do), causal=causal, sm_scale=scale)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip(got, _jax_attention_grads(q, k, v, do, causal, scale)):
        _assert_rel(g, w, ATTN_REL)


def test_attention_bwd_rejects_rectangular_causal_and_empty_shapes():
    q = torch.zeros(1, 2, 4, 8)
    k = torch.zeros(1, 2, 6, 8)
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        flash_attention_bwd(q, k, k, q, q, causal=True)
    got = flash_attention_bwd(q, k, k, q, q, causal=False)
    assert [tuple(g.shape) for g in got] == [(1, 2, 4, 8), (1, 2, 6, 8), (1, 2, 6, 8)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention_bwd(*(torch.zeros(1, 1, 2, 2, device="meta"),) * 5)


def _ssd_inputs(case, seed):
    rng = np.random.default_rng(seed)
    if case is None:  # the reference's decay extremes: dt 5, A (-8, -0.001)
        b, l, h, dh, ds, chunk = 1, 128, 2, 8, 16, 64
        dt = np.full((b, l, h), 5.0)
        A = np.array([-8.0, -0.001])
    else:
        b, l, h, dh, ds, chunk = case
        dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))) * 0.1
        A = -np.exp(rng.normal(size=(h,)))
    x = rng.normal(size=(b, l, h, dh))
    B, C = rng.normal(size=(b, l, ds)), rng.normal(size=(b, l, ds))
    dy = rng.normal(size=(b, l, h, dh))
    return (x, dt, A, B, C), dy, chunk


@functools.partial(jax.jit, static_argnums=2)
def _jax_ssd_grads(xs, dy, chunk):
    _, vjp = jax.vjp(lambda *a: jssd_chunked_ref(*a, chunk=chunk)[0], *xs)
    return vjp(dy)


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_bwd_twin_matches_jax_grad_and_autograd(case):
    xs, dy, chunk = _ssd_inputs(case, seed=11)
    want = _jax_ssd_grads(tuple(map(jnp.asarray, xs)), jnp.asarray(dy), chunk)
    t = [torch.from_numpy(a) for a in xs]
    got = ssd_bwd_ref(*t, torch.from_numpy(dy), chunk=chunk)
    leaves = [a.clone().requires_grad_() for a in t]
    chunked = torch.autograd.grad(ssd_chunked_ref(*leaves, chunk=chunk)[0], leaves,
                                  torch.from_numpy(dy))
    leaves = [a.clone().requires_grad_() for a in t]
    seq = torch.autograd.grad(ssd_ref(*leaves)[0], leaves, torch.from_numpy(dy))
    for name, g, w, c, s in zip(("dx", "ddt", "dA", "dB", "dC"), got, want, chunked, seq):
        assert g.dtype == torch.float64 and g.shape == c.shape
        assert torch.isfinite(g).all(), name
        _assert_rel(g, w, SSD_REL, name)
        _assert_rel(g, c, SSD_REL, name)
        _assert_rel(g, s, SSD_REL, name)


@pytest.mark.parametrize("case", SSD_CASES[:2] + [None], ids=str)
def test_ssd_function_on_the_cpu_runs_the_twin(case):
    xs, dy, chunk = _ssd_inputs(case, seed=12)
    leaves = [torch.from_numpy(a).requires_grad_() for a in xs]
    before = SSD_SCAN_BWD.launches
    y = _SSDScan.apply(*leaves, chunk)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert SSD_SCAN_BWD.launches == before
    want = ssd_scan_bwd(*(a.detach() for a in leaves), torch.from_numpy(dy), chunk=chunk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_bwd_in_float32_matches_float64():
    """The twin in the kernel's float32, at the decay extremes and a
    multi-chunk shape, within 1e-4 of each float64 gradient's max|.| (the
    limit ``chip_smoke.py`` holds the kernel to)."""
    for case in (None, SSD_CASES[0]):
        xs, dy, chunk = _ssd_inputs(case, seed=13)
        t64 = [torch.from_numpy(a) for a in xs] + [torch.from_numpy(dy)]
        want = ssd_bwd_ref(*t64, chunk=chunk)
        got = ssd_bwd_ref(*(a.float() for a in t64), chunk=chunk)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and torch.isfinite(g).all()
            _assert_rel(g, w, 1e-4)
