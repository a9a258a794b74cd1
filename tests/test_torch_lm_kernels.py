"""The LM kernels' plain twins against the reference, run as the reference's
own tests run its Pallas kernels on the CPU (interpret mode), at the
reference's test shapes and tolerances (``tests/test_kernels.py``: 2e-5
float32 / 3e-2 bfloat16 for attention, 5e-4 for the SSD's y and 5e-5 for its
state).

On the CPU the flash-attention and SSD-scan wrappers are their twins; the
CUDA kernels are held against the same twins on the card
(``tests/test_torch_cuda.py`` and chip_smoke.py phase 3).  Inputs are numpy
draws fed to both frameworks.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.ssd_scan.ref import ssd_chunked_ref as jssd_chunked_ref
from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan as jssd_scan
from repro.models.attention import _chunked as j_chunked
from repro.models.attention import decode_attention as jdecode_attention
from repro_torch.benchmarks import flash_variants, ssd_variants
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import FLASH_ATTENTION, SSD_SCAN
from repro_torch.kernels._build import CSRC_DIR
from repro_torch.kernels.flash_attention.flash_attention import (_ENTRY, MAX_HEAD_DIM,
                                                                 ROUTE_LAUNCHES,
                                                                 bwd_wgmma_smem_bytes,
                                                                 flash_attention,
                                                                 route, tf32_smem_bytes,
                                                                 wgmma_smem_bytes)
from repro_torch.kernels.flash_attention.ops import _FlashAttention, attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan.ops import _SSDScan, ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (bwd_heads_per_block, bwd_smem_bytes,
                                                   smem_bytes, ssd_scan)
from repro_torch.models.attention import _chunked, decode_attention


def _qkv(b, hq, hk, sq, sk, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(dtype),
            rng.normal(size=(b, hk, sk, d)).astype(dtype),
            rng.normal(size=(b, hk, sk, d)).astype(dtype))


def _np(x):
    return np.asarray(x, np.float32)


# -- flash attention ------------------------------------------------------------

@pytest.mark.parametrize(
    "b,hq,hk,s,d,causal",
    [
        (2, 4, 2, 256, 64, True),
        (1, 8, 1, 128, 128, True),   # MQA
        (2, 2, 2, 256, 64, False),
        (1, 4, 4, 384, 32, True),    # MHA, 3 kv blocks
        (1, 16, 4, 256, 64, True),   # GQA group 4
    ],
)
def test_attention_twin_matches_reference(b, hq, hk, s, d, causal):
    q, k, v = _qkv(b, hq, hk, s, s, d, seed=s + hq)
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    kernel = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)
    oracle = jattention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got, _np(kernel), atol=2e-5)
    np.testing.assert_allclose(got, _np(oracle), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_twin_dtypes(dtype):
    q, k, v = _qkv(1, 2, 2, 256, 256, 64, seed=20)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (q, k, v))
    got = attention_ref(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype
    want = jflash(jq, jk, jv, causal=True, interpret=True)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol)


def test_attention_twin_sm_scale_and_ragged_length():
    q, k, v = _qkv(1, 2, 2, 128, 128, 64, seed=40)
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True, sm_scale=0.5)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=True, sm_scale=0.5, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)
    # a length no 128-block divides (the TPU kernel refuses it; the twin and
    # the CUDA kernel take it): against the reference's oracle
    for causal in (True, False):
        q, k, v = _qkv(2, 4, 2, 200, 200, 16, seed=41)
        got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
        want = jattention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)


def test_causal_attention_needs_equal_lengths():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 2, 64, 128, 16, seed=1))
    for call in (lambda: attention_ref(q, k, v, causal=True),
                 lambda: flash_attention(q, k, v, causal=True),
                 lambda: attention(q, k, v, causal=True)):
        with pytest.raises(ValueError, match="seq_q == seq_k"):
            call()
    # bidirectional attention takes any lengths, as the reference's oracle
    got = attention_ref(q, k, v, causal=False)
    want = jattention_ref(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())), causal=False)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)


@pytest.mark.parametrize("use_kernel", ["auto", "never", "interpret"])
def test_attention_dispatch_on_cpu_is_the_twin(use_kernel):
    q, k, v = map(torch.from_numpy, _qkv(2, 4, 2, 64, 64, 16, seed=3))
    before = FLASH_ATTENTION.launches
    got = attention(q, k, v, causal=True, use_kernel=use_kernel)
    assert FLASH_ATTENTION.launches == before
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=True), rtol=0, atol=0)


# Every configuration that runs attention, with its head dim.
ATTENTION_ARCHS = [a for a in list_archs() if get_arch(a).n_heads > 0]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_flash_route_at_every_config_head_dim(arch):
    d = get_arch(arch).resolved_head_dim
    assert d % 8 == 0 and d <= MAX_HEAD_DIM
    assert route(torch.bfloat16, d) == "wgmma"     # the bf16 models: tensor cores
    assert route(torch.float32, d) == "mma_tf32"   # float32-exact TF32 tensor cores


@pytest.mark.parametrize("d,want", [(8, "wgmma"), (16, "wgmma"), (64, "wgmma"),
                                    (120, "wgmma"), (128, "wgmma"), (1, "simt"),
                                    (36, "simt"), (100, "simt"), (127, "simt"),
                                    (136, "simt")])
def test_flash_route_by_head_dim(d, want):
    """wgmma for bf16 with d % 8 == 0 (TMA's 16-byte row stride) and d <= 128,
    the SIMT kernel for other bf16; every float32 call takes mma_tf32 (the
    wrapper refuses d > 128 before any route), and no float32 entry of the
    SIMT kernel is left to reach."""
    assert route(torch.bfloat16, d) == want
    assert route(torch.float32, d) == "mma_tf32"
    assert set(_ENTRY["simt"]) == {torch.bfloat16}


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_wgmma_shared_memory_fits_every_config_head_dim(arch):
    # the q tile (128 rows) and two K/V stages (128 rows each), each row
    # padded to 128 bf16 columns, 7 mbarriers and the 1024-byte alignment
    d = get_arch(arch).resolved_head_dim
    assert wgmma_smem_bytes(d) == 128 * 256 + 2 * 2 * 128 * 256 + 7 * 8 + 1024 == 164920
    assert wgmma_smem_bytes(d) <= 232448
    with pytest.raises(ValueError, match="wgmma"):
        wgmma_smem_bytes(36)


@pytest.mark.parametrize("d", sorted({1, 36, 100, 127}
                                     | {get_arch(a).resolved_head_dim for a in ATTENTION_ARCHS}))
def test_tf32_shared_memory_fits_a_block_an_sm(d):
    # the K/V ring (two stages of 64 rows) and the 128-row q tile, d padded
    # to a multiple of 16 and rows strided 8 (mod 32) floats for K and Q, 4
    # (mod 8) for V.  The design wants one block of 8 warps an SM: its bytes
    # within a block's most, and with the 1 KB the SM reserves for it
    # within the SM's 228 KB.
    dp = -(-d // 16) * 16
    ldk, ldv = dp + (8 if dp % 32 == 0 else 24), dp + 4
    assert ldk % 32 == 8 and ldv % 8 == 4
    assert tf32_smem_bytes(d) == 4 * (2 * 64 * (ldk + ldv) + 128 * ldk)
    assert tf32_smem_bytes(d) <= 232448
    assert tf32_smem_bytes(d) + 1024 <= 233472
    assert tf32_smem_bytes(128) == 206848
    with pytest.raises(ValueError, match="head dim"):
        tf32_smem_bytes(129)


def test_flash_on_cpu_counts_no_route():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(1, 4, 2, 64, 64, 112, 4))
    before = dict(ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, causal=True)
    assert ROUTE_LAUNCHES == before
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=True), rtol=0, atol=0)


@pytest.mark.parametrize(
    "sq,chunk,hq,hk,causal",
    [(64, 16, 4, 2, True), (48, 32, 4, 4, True),   # 48 % 32: the gcd fallback
     (40, 512, 2, 1, False), (64, 64, 8, 2, True)],
)
def test_chunked_matches_reference(sq, chunk, hq, hk, causal):
    q, k, v = _qkv(2, hq, hk, sq, sq, 16, seed=sq + chunk)
    got = _chunked(*map(torch.from_numpy, (q, k, v)), causal=causal, sm_scale=0.25,
                   chunk=chunk)
    want = j_chunked(*map(jnp.asarray, (q, k, v)), causal=causal, sm_scale=0.25,
                     chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_decode_attention_matches_reference(pos):
    q, kc, vc = _qkv(2, 4, 2, 1, 16, 16, seed=pos)
    got = decode_attention(*map(torch.from_numpy, (q, kc, vc)), pos)
    want = jdecode_attention(*map(jnp.asarray, (q, kc, vc)), jnp.int32(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)
    got_t = decode_attention(*map(torch.from_numpy, (q, kc, vc)), torch.tensor(pos))
    torch.testing.assert_close(got_t, got, rtol=0, atol=0)


# -- SSD scan -------------------------------------------------------------------

def _ssd_inputs(b, l, h, dh, ds, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, dh)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(b, l, h)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)))).astype(np.float32)
    B = rng.normal(size=(b, l, ds)).astype(np.float32)
    C = rng.normal(size=(b, l, ds)).astype(np.float32)
    return x, dt, A, B, C


SSD_SHAPES = [
    (2, 128, 3, 16, 32, 32),
    (1, 256, 2, 64, 128, 128),
    (2, 64, 4, 8, 16, 64),   # single chunk
    (1, 512, 1, 32, 64, 64),
]


@pytest.mark.parametrize("b,l,h,dh,ds,chunk", SSD_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_twins_match_reference(b, l, h, dh, ds, chunk, with_state):
    xs = _ssd_inputs(b, l, h, dh, ds, seed=l + h)
    S0 = (np.random.default_rng(7).normal(size=(b, h, dh, ds)).astype(np.float32)
          if with_state else None)
    t = [torch.from_numpy(a) for a in xs]
    j = [jnp.asarray(a) for a in xs]
    tS0 = None if S0 is None else torch.from_numpy(S0)
    jS0 = None if S0 is None else jnp.asarray(S0)
    y_seq, S_seq = jssd_ref(*j, S0=jS0)
    y_chk, S_chk = jssd_chunked_ref(*j, chunk=chunk, S0=jS0)
    got_seq = ssd_ref(*t, S0=tS0)
    got_chk = ssd_chunked_ref(*t, chunk=chunk, S0=tS0)
    for (gy, gS), (wy, wS) in (((got_seq), (y_seq, S_seq)), ((got_chk), (y_chk, S_chk)),
                               ((got_chk), (y_seq, S_seq))):
        np.testing.assert_allclose(gy.numpy(), _np(wy), atol=5e-4)
        np.testing.assert_allclose(gS.numpy(), _np(wS), atol=5e-5)
    if S0 is None:  # the TPU kernel starts from a zero state and returns y
        y_pal = jssd_scan(*j, chunk=chunk, interpret=True)
        np.testing.assert_allclose(got_chk[0].numpy(), _np(y_pal), atol=5e-4)
        np.testing.assert_allclose(ssd_scan(*t, chunk=chunk).numpy(), _np(y_pal), atol=5e-4)


def test_ssd_decay_extremes():
    """Strong decay (dt large) must not produce NaN/inf."""
    b, l, h, dh, ds = 1, 128, 2, 8, 16
    x, _, _, B, C = _ssd_inputs(b, l, h, dh, ds, seed=0)
    dt = np.full((b, l, h), 5.0, np.float32)
    A = np.array([-8.0, -0.001], np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y = ssd(*t, chunk=64)
    assert torch.isfinite(y).all()
    y_seq, _ = jssd_ref(*(jnp.asarray(a) for a in (x, dt, A, B, C)))
    np.testing.assert_allclose(y.numpy(), _np(y_seq), atol=5e-4)


@pytest.mark.parametrize("use_kernel", ["auto", "never", "interpret"])
def test_ssd_dispatch_on_cpu_is_the_chunked_twin(use_kernel):
    t = [torch.from_numpy(a) for a in _ssd_inputs(2, 64, 3, 8, 16, seed=5)]
    before = SSD_SCAN.launches
    got = ssd(*t, chunk=128, use_kernel=use_kernel)  # chunk clipped to l
    assert SSD_SCAN.launches == before
    torch.testing.assert_close(got, ssd_chunked_ref(*t, chunk=64)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="multiple"):
        ssd(*t, chunk=48, use_kernel=use_kernel)


def _constants(*sources: str) -> dict:
    """The ``constexpr int`` constants of CUDA sources (headers first), by
    name, where each is a literal or a product, sum or quotient of earlier
    ones."""
    import re

    out = {}
    text = "".join((CSRC_DIR / source).read_text() for source in sources)
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        try:
            out[name] = int(eval(expr, {}, dict(out)))  # noqa: S307 (the repo's own source)
        except NameError:
            continue
    return out


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_bwd_wgmma_shared_memory_fits_every_config_head_dim(arch):
    # two own tiles of 128 rows and two stages of two 64-row tiles, each row
    # padded to 128 bf16 columns, a stage's lse and D (2 x 64 floats), 5
    # mbarriers and the 1024-byte alignment: the source's kBwSmemBytes
    d = get_arch(arch).resolved_head_dim
    k = _constants("wgmma.cuh", "flash_attention_bwd.cu")
    assert bwd_wgmma_smem_bytes(d) == k["kBwSmemBytes"]
    assert k["kBwSmemBytes"] == 2 * 128 * 256 + 2 * (2 * 64 * 256 + 2 * 4 * 64) + 5 * 8 + 1024
    assert bwd_wgmma_smem_bytes(d) + 1024 <= 233472  # one block an SM
    with pytest.raises(ValueError, match="wgmma"):
        bwd_wgmma_smem_bytes(36)


def test_ssd_bwd_shared_memory_fits_the_served_shapes():
    # zamba2-7b (dh 64, ds 64) and mamba2-130m (dh 64, ds 128) at chunk 128:
    # the chunk launch holds C.B^T's lower triangle of 16 x 16 blocks (rows
    # strided 20), a head's u and dy, its S_in and G, C and B where ds <= 64,
    # a head's dt, cum, dcum's sides, x.du and 256 partial sums, and each of
    # the 8 warps' table of decays; the outer launch dt, cum and weights
    # with the weighted rows and B or C
    k = _constants("ssd_scan_bwd.cu")
    assert (k["kLdb"], k["kThreads"], k["kWarps"], k["kSharedDs"]) == (20, 256, 8, 64)
    tri = 8 * 9 // 2 * 16 * k["kLdb"]
    assert bwd_smem_bytes(128, 64, 64) == {
        "outer": 4 * (3 * 128 + 128 * 64 + 128 * 64),
        "chunk": 4 * (tri + 2 * 128 * 68 + 2 * 128 * 68 + 2 * 64 * 68 + 5 * 128 + 256
                      + 8 * 128)}
    assert bwd_smem_bytes(128, 64, 128) == {
        "outer": 4 * (3 * 128 + 128 * 64 + 128 * 128),
        "chunk": 4 * (tri + 2 * 128 * 68 + 2 * 64 * 132 + 5 * 128 + 256 + 8 * 128)}
    assert bwd_smem_bytes(128, 64, 64) == {"outer": 67072, "chunk": 227840}
    for dh, ds in ((64, 64), (64, 128)):
        got = bwd_smem_bytes(128, dh, ds)
        assert got["chunk"] + 1024 <= 233472  # one chunk block an SM
        assert 2 * (got["outer"] + 1024) <= 233472  # two outer blocks an SM at least
    # the head groups: zamba2-7b's 112 heads on 132 SMs in groups of 7,
    # mamba2-130m's ds = 128 one head a block
    assert bwd_heads_per_block(2 * 16, 112, 64, 132) == 7
    assert bwd_heads_per_block(16, 24, 128, 132) == 1


def test_ssd_shared_memory_fits_the_served_shapes():
    # zamba2-7b (dh 64, ds 64) and mamba2-130m (dh 64, ds 128) at chunk 128:
    # the state kernel holds B and x of a head, the chunk kernel C, C.B^T and
    # x and S_in of a head (B while C.B^T is formed); zamba2-7b's x (and
    # S_in) double-buffered across heads, mamba2-130m's single
    assert smem_bytes(128, 64, 64) == {"state": 114688, "chunk": 227328}
    assert smem_bytes(128, 64, 128) == {"state": 110592, "chunk": 222208}
    for dh, ds in ((64, 64), (64, 128)):
        got = smem_bytes(128, dh, ds)
        assert got["chunk"] <= 232448  # a block's most
        assert 2 * (got["state"] + 1024) <= 233472  # two state blocks an SM


# -- the CUDA kernel's TF32 hi + lo split, emulated ------------------------------

def _tf32(a):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernel rounds its operands' parts (cvt.rna's rounding)."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_split(a, b):
    """a @ b as the kernel's mma.sync passes form it: both operands split
    into TF32 hi + lo parts, lo.hi + hi.lo + hi.hi accumulated in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_trunc(a):
    """float32 truncated to TF32, as the tensor cores read an operand."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_split_lo_truncated(a, b):
    """a @ b as flash_attention's mma_tf32 route forms it: hi parts rounded
    to TF32 as in ``_mm_split``, lo parts left unrounded for the tensor
    cores, which truncate them."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_single(a, b):
    """a @ b as a single TF32 pass would form it."""
    return _tf32(a) @ _tf32(b)


def _emulated_kernel(x, dt, A, B, C, chunk, mm):
    """y of csrc/ssd_scan.cu in plain float32 torch, in its three launches'
    order, every product through ``mm``: (1) each chunk's increment
    (w dt x)^T B and decay, (2) the state pass, (3) C.B^T, M = C.B^T *
    exp(cum_t - cum_s) at s <= t, y = M (dt x) + exp(cum_t) C S_in^T."""
    b, l, h, dh = x.shape
    ds, nc = B.shape[-1], l // chunk
    xr = x.reshape(b, nc, chunk, h, dh)
    dtr = dt.reshape(b, nc, chunk, h)
    Br, Cr = B.reshape(b, nc, chunk, ds), C.reshape(b, nc, chunk, ds)
    cum = torch.cumsum(A * dtr, dim=2)  # (b, nc, L, h)
    dx = dtr[..., None] * xr  # (b, nc, L, h, dh)
    w = torch.exp(cum[:, :, -1:, :] - cum)
    inc = mm((dx * w[..., None]).permute(0, 1, 3, 4, 2), Br[:, :, None])  # (b,nc,h,dh,ds)
    decay = torch.exp(cum[:, :, -1, :])
    S, S_in = torch.zeros_like(inc[:, 0]), []
    for n in range(nc):
        S_in.append(S)
        S = decay[:, n, :, None, None] * S + inc[:, n]
    S_in = torch.stack(S_in, dim=1)
    CB = mm(Cr, Br.transpose(-1, -2))  # (b, nc, t, s)
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()[None, None, :, :, None]
    seg = torch.where(mask, cum[:, :, :, None, :] - cum[:, :, None, :, :], -torch.inf)
    M = (CB[..., None] * torch.exp(seg)).permute(0, 1, 4, 2, 3)  # (b, nc, h, t, s)
    y_intra = mm(M, dx.permute(0, 1, 3, 2, 4))  # (b, nc, h, t, dh)
    y_inter = mm(Cr[:, :, None], S_in.transpose(-1, -2))
    y = y_intra + torch.exp(cum).permute(0, 1, 3, 2)[..., None] * y_inter
    return y.permute(0, 1, 3, 2, 4).reshape(b, l, h, dh)


def _split_case(case):
    if case == "decay-extremes":  # chip_smoke.py's: dt 5, A (-8, -0.001)
        x, _, _, B, C = _ssd_inputs(1, 128, 2, 8, 16, seed=0)
        dt = np.full((1, 128, 2), 5.0, np.float32)
        return (x, dt, np.array([-8.0, -0.001], np.float32), B, C), 64
    b, l, h, dh, ds, chunk = case  # the LM widths, depth cut to 4 chunks
    return _ssd_inputs(b, l, h, dh, ds, seed=11), chunk


SPLIT_CASES = [(2, 512, 4, 64, 64, 128), (1, 512, 3, 64, 128, 128), "decay-extremes"]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_ssd_tf32_split_holds_the_kernel_bound(case):
    """The kernel's products, emulated with the hi + lo TF32 split, stay
    within chip_smoke.py's 1e-5 of max|y| of the float64 chunked twin."""
    xs, chunk = _split_case(case)
    want = ssd_chunked_ref(*(torch.from_numpy(a).double() for a in xs), chunk=chunk)[0]
    got = _emulated_kernel(*map(torch.from_numpy, xs), chunk, _mm_split)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    scale = want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_ssd_single_tf32_pass_misses_the_kernel_bound(case):
    """The witness for the split: one TF32 pass per product (about three
    digits) misses 1e-5 of max|y|, so it would change the float32 function."""
    xs, chunk = _split_case(case)
    want = ssd_chunked_ref(*(torch.from_numpy(a).double() for a in xs), chunk=chunk)[0]
    got = _emulated_kernel(*map(torch.from_numpy, xs), chunk, _mm_single)
    scale = want.abs().max().item()
    assert (got.double() - want).abs().max().item() > 1e-5 * scale


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -1.0 - 2.0 ** -11,
                      1.0 + 2.0 ** -12, -3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -1.0 - 2.0 ** -10, 1.0, -3.0],
                        dtype=torch.float32)
    torch.testing.assert_close(_tf32(a), want, rtol=0, atol=0)
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(r)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - hi).abs() <= r.abs() * 2.0 ** -11).all()
    lo = _tf32(r - hi)
    assert ((r.double() - hi.double() - lo.double()).abs() <= r.abs().double() * 2.0 ** -21).all()


def test_kernel_backwards_raise_not_yet_ported():
    """The two kernels' autograd Functions have a backward now: on a CPU
    tensor it runs the backward twin, equal to autograd through the forward
    twin (``tests/test_torch_lm_backward.py`` holds both to ``jax.grad``)."""
    q, k, v = (t.requires_grad_() for t in map(torch.from_numpy, _qkv(1, 2, 2, 16, 16, 8, 9)))
    out = _FlashAttention.apply(q, k, v, True, None)
    got = torch.autograd.grad(out.sum(), (q, k, v))
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True).sum(), (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    t = [torch.from_numpy(a).requires_grad_() for a in _ssd_inputs(1, 16, 2, 4, 8, 1)]
    y = _SSDScan.apply(*t, 16)
    got = torch.autograd.grad(y.sum(), t)
    want = torch.autograd.grad(ssd_chunked_ref(*t, chunk=16)[0].sum(), t)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# -- the flash-attention mma_tf32 route's hi + lo split, emulated ---------------

def _emulated_flash(q, k, v, causal, mm, block_k=64):
    """O of csrc/flash_attention.cu's mma_tf32 route in plain float32 torch:
    per KV tile of the kernel's 64 keys, S = Q K^T through ``mm``, scaled by
    sm_scale log2 e (rounded to float32 as the launcher rounds it) and
    masked; the online softmax in base 2 (a row with no key yet shifts by
    0); O += P V through ``mm``; O / l with l == 0 read as 1."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    scale = torch.tensor(1.4426950408889634 / math.sqrt(d), dtype=torch.float32)
    m = torch.full((b, hq, s), -torch.inf)
    l, acc = torch.zeros(b, hq, s), torch.zeros(b, hq, s, d)
    rows = torch.arange(s)[:, None]
    for k0 in range(0, k.shape[2], block_k):
        kt, vt = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        x = mm(q, kt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            x = torch.where(cols > rows, -torch.inf, x)
        mx = torch.maximum(m, x.amax(-1))
        shift = torch.where(mx == -torch.inf, 0.0, mx)
        alpha = torch.exp2(m - shift)
        p = torch.exp2(x - shift[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm(p, vt)
        m = mx
    return acc / torch.where(l == 0, 1.0, l)[..., None]


# The reference's kernel-test shapes (b, hq, hk, s, d, causal), then
# zamba2-7b's head dim (112) and qwen3-1.7b's (128, GQA 2), depth cut.
FLASH_SPLIT_CASES = [(2, 4, 2, 256, 64, True), (1, 8, 1, 128, 128, True),
                     (2, 2, 2, 256, 64, False), (1, 4, 4, 384, 32, True),
                     (1, 16, 4, 256, 64, True), (1, 8, 2, 256, 112, True),
                     (1, 16, 8, 256, 128, True)]


@functools.lru_cache(maxsize=None)
def _flash_split_case(case):
    """Numpy inputs and the reference's float32 kernel (interpret mode) on them."""
    b, hq, hk, s, d, causal = case
    q, k, v = _qkv(b, hq, hk, s, s, d, seed=s + hq + d)
    want = _np(jflash(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True))
    return (q, k, v), want


@pytest.mark.parametrize("case", FLASH_SPLIT_CASES, ids=str)
def test_flash_tf32_split_holds_the_reference_tolerance(case):
    """The mma_tf32 route's products, emulated with the hi + lo TF32 split of
    Q, K, P and V (hi rounded, lo truncated, as the kernel forms them),
    stay within the reference's 2e-5 of its float32 kernel, as the split
    with both parts rounded does."""
    (q, k, v), want = _flash_split_case(case)
    for mm in (_mm_split_lo_truncated, _mm_split):
        got = _emulated_flash(*map(torch.from_numpy, (q, k, v)), case[5], mm)
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", FLASH_SPLIT_CASES, ids=str)
def test_flash_single_tf32_pass_misses_the_reference_tolerance(case):
    """The witness for the split: one TF32 pass per product misses 2e-5 on
    the same inputs, so it would change the float32 function."""
    (q, k, v), want = _flash_split_case(case)
    got = _emulated_flash(*map(torch.from_numpy, (q, k, v)), case[5], _mm_single)
    assert np.abs(got.numpy() - want).max() > 2e-5


# -- the design-variant harnesses edit the committed sources --------------------

@pytest.mark.parametrize("route_variant", [(r, n) for r in flash_variants.VARIANTS
                                           for n in flash_variants.VARIANTS[r]], ids=str)
def test_flash_variants_edit_the_committed_source(route_variant):
    # flash_attention.cu with tf32_split.cuh inlined, so that a variant can
    # edit the split where this kernel includes it (ssd_scan.cu keeps its own)
    committed = flash_variants.edited_source(route_variant[0], "committed")
    assert '#include "tf32_split.cuh"' not in committed and "round_tf32" in committed
    edited = flash_variants.edited_source(*route_variant)
    assert (edited == committed) == (route_variant[1] == "committed")


@pytest.mark.parametrize("variant", sorted(ssd_variants.VARIANTS))
def test_ssd_variants_edit_the_committed_source(variant):
    # ssd_scan.cu with tf32_split.cuh inlined: the split's helpers are edited
    # where the kernel's source includes them
    edited = ssd_variants.edited_source(variant)
    committed = ssd_variants.edited_source("committed")
    assert '#include "tf32_split.cuh"' not in committed and "round_tf32" in committed
    assert (edited == committed) == (variant == "committed")
