"""The backward kernels' split products, emulated on the CPU.

``csrc/flash_attention_bwd.cu``'s wgmma route takes P and dS into its dV,
dK and dQ products from registers as bf16: split into bf16 hi + lo parts,
two products each.  ``csrc/ssd_scan_bwd.cu`` runs its within-chunk products
on TF32 ``mma.sync`` with ``tf32_split.cuh``'s hi + lo split of both
operands, the lo parts left for the tensor cores to truncate
(``split_lo_truncated``), which holds the same limits as rounding them.  Each design is emulated here in plain torch, in the kernel's
order, and held to the limits ``chip_smoke.py`` phase 3 and 18b hold the
kernels to; a witness shows that a single rounding (one bf16 P and dS, one
TF32 pass) misses them.  The tensor cores' accumulation toward zero is
emulated too: a GQA group's dK sum drifts less flushed per query head.
Inputs are numpy draws from a seed.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref

# chip_smoke.py's limits: the bf16 gate elementwise against the float32
# twin (phase 3), the SSD's gradients against the float64 twin (phase 3's
# SSD_BWD_REL) and within 3x the float32 twin's distance (18b)
BF16_REL, BF16_ABS = 2.0 ** -8, 1e-5
SSD_BWD_REL = 1e-4
TWIN_RATIO = 3.0


# -- attention: P and dS in bf16 hi + lo ---------------------------------------

def _bf16(a):
    return a.to(torch.bfloat16).float()


def _bf16_split(a):
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def _mm_bf16_split(p, b):
    """p @ b with p (float32) taken as bf16 hi + lo, two products summed in
    float32 (b is bf16-exact)."""
    hi, lo = _bf16_split(p)
    return hi @ b + lo @ b


def _mm_bf16_single(p, b):
    """p @ b with p rounded once to bf16, as FlashAttention's backward does."""
    return _bf16(p) @ b


def _emulated_attention_bwd(q, k, v, out, do, mm):
    """dq, dk, dv of the wgmma route in float32 torch (bf16-exact inputs,
    causal, one KV head a query head): the row statistics in base 2 as the
    stats launch forms them, P = 2^(S sm_scale log2 e - lse), dS = P (dP -
    D), then dV = P^T dO, dK = sm_scale dS^T Q and dQ = sm_scale dS K
    through ``mm``; the gradients rounded to bf16."""
    s, d = q.shape[-2], q.shape[-1]
    c = math.log2(math.e) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    S = torch.where(mask, (q @ k.transpose(-1, -2)) * c, -torch.inf)
    m = S.amax(-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(S - m).sum(-1, keepdim=True))
    P = torch.exp2(S - lse)
    D = (do * out).sum(-1, keepdim=True)
    dS = P * (do @ v.transpose(-1, -2) - D)
    scale = 1.0 / math.sqrt(d)
    dv = mm(P.transpose(-1, -2), do)
    dk = scale * mm(dS.transpose(-1, -2), q)
    dq = scale * mm(dS, k)
    return tuple(_bf16(g) for g in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _attention_case():
    """zamba2-7b's head dim at 1024 tokens, causal: bf16 inputs, the
    kernel's bf16 output, and the float32 twin's gradients."""
    rng = np.random.default_rng(26)
    q, k, v, do = (_bf16(torch.from_numpy(rng.normal(size=(1, 2, 1024, 112)).astype(np.float32)))
                   for _ in range(4))
    out = _bf16(attention_ref(q, k, v, causal=True))
    want = attention_bwd_ref(q, k, v, out, do, causal=True)
    return (q, k, v, out, do), want


def _gate_ratio(got, want):
    """The largest |got - want| over the phase-3 bf16 gate's allowance."""
    allow = BF16_REL * want.abs() + BF16_ABS * want.abs().max()
    return ((got - want).abs() / allow).max().item()


def test_attention_bwd_split_holds_the_bf16_gate():
    ins, want = _attention_case()
    got = _emulated_attention_bwd(*ins, _mm_bf16_split)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _gate_ratio(g, w) <= 1.0


def test_attention_bwd_single_bf16_rounding_misses_the_gate():
    """The witness: P and dS rounded once to bf16 miss the gate (by some
    tens of times)."""
    ins, want = _attention_case()
    got = _emulated_attention_bwd(*ins, _mm_bf16_single)
    assert min(_gate_ratio(g, w) for g, w in zip(got, want)) > 10.0


# -- attention: a GQA group's dK and dV, one accumulator or one a head ------

def _round_toward_zero(x):
    """float64 -> float32, toward zero (the tensor cores' accumulation)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _group_sum(terms, heads_per_acc, rounding):
    """The dkdv launch's sum of one key's (heads, rows, d) terms: k-steps of
    16 rows added into a float32 accumulator with ``rounding`` (each step's
    16 products and the accumulator summed exactly, then rounded), a fresh
    accumulator every ``heads_per_acc`` heads, the accumulators added in head
    order to nearest."""
    heads, rows, d = terms.shape
    total = None
    for h0 in range(0, heads, heads_per_acc):
        acc = np.zeros(d, np.float32)
        for h in range(h0, h0 + heads_per_acc):
            for r in range(0, rows, 16):
                acc = rounding(acc.astype(np.float64) + terms[h, r:r + 16].sum(0))
        total = acc if total is None else (total.astype(np.float64) + acc).astype(np.float32)
    return total


def test_gqa_dk_flushed_per_head_drifts_less_than_one_accumulator():
    """A KV head's dK and dV over its group of 8 query heads x 2048 rows:
    rounded toward zero at every k-step into one accumulator, the sum drifts
    several times as far as with a fresh accumulator per head (what
    ``flash_attention_bwd``'s dkdv launch does for GQA), and far beyond
    rounding to nearest."""
    rng = np.random.default_rng(27)
    heads, rows, d = 8, 2048, 128
    weight = 1.0 / (1.0 + np.arange(rows) / 64.0)  # the early rows weigh most
    ds = (rng.normal(size=(heads, rows)) * weight).astype(np.float32)
    q = rng.normal(size=(heads, rows, d)).astype(np.float32)
    terms = ds[:, :, None].astype(np.float64) * q.astype(np.float64)
    exact = terms.sum(axis=(0, 1))
    err = {name: np.abs(_group_sum(terms, per, rounding) - exact).mean()
           for name, per, rounding in (
               ("one accumulator", heads, _round_toward_zero),
               ("a head each", 1, _round_toward_zero),
               ("to nearest", heads, lambda x: x.astype(np.float32)))}
    assert err["one accumulator"] > 3 * err["a head each"]
    assert err["a head each"] > 3 * err["to nearest"]


# -- attention at 8192 tokens: one accumulator a head's rows or a row's keys ---

LONG_S, LONG_D = 8192, 128  # qwen3-moe-30b-a3b's and hubert-xlarge's long cases


def _toward_zero(x):
    """float64 -> float32 toward zero, in torch (the tensor cores' accumulation)."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _accumulate(terms_a, terms_b):
    """sum_r a[r, i] b[r, :] for every i, as one wgmma accumulator takes it:
    k-steps of 16 rows, each step's products and the accumulator summed
    exactly, then rounded toward zero."""
    a, b = terms_a.double(), terms_b.double()
    acc = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float32)
    for r in range(0, a.shape[0], 16):
        acc = _toward_zero(acc.double() + a[r:r + 16].T @ b[r:r + 16])
    return acc


LONG_KEYS = LONG_ROWS = 512  # dK's first keys and dQ's last rows: the longest sums


@pytest.fixture
def one_thread():
    """One intra-op thread: these loops of small products run slowest on a
    thread pool that shares its cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _long_case():
    """One causal head at 8192 tokens, d = 128, bf16 inputs from a seed, as
    the kernel forms them in float32, in blocks of rows: the row statistics
    (lse, D = rowsum(dO O), O rounded to bf16) and the largest |dQ| and
    |dK| of the whole head (the gate's absolute term); then dS = P (dP - D)
    for dK's first ``LONG_KEYS`` keys (every row) and dQ's last
    ``LONG_ROWS`` rows (every key), the sums that run over the most terms."""
    rng = np.random.default_rng(28)
    q, k, v, do = (_bf16(torch.from_numpy(rng.normal(size=(LONG_S, LONG_D)).astype(np.float32)))
                   for _ in range(4))
    scale = 1.0 / math.sqrt(LONG_D)
    rows = torch.arange(LONG_S)

    def scores(r0, r1, keys):
        s = (q[r0:r1] @ k[keys].T) * scale
        return s.masked_fill(rows[r0:r1, None] < rows[keys][None, :], -torch.inf)

    lse, delta = torch.empty(LONG_S), torch.empty(LONG_S)
    dk, dq_top = torch.zeros(LONG_S, LONG_D), 0.0
    for r0 in range(0, LONG_S, 1024):
        s = scores(r0, r0 + 1024, slice(None))
        lse[r0:r0 + 1024] = torch.logsumexp(s, -1)
        p = torch.exp(s - lse[r0:r0 + 1024, None])
        delta[r0:r0 + 1024] = (do[r0:r0 + 1024] * _bf16(p @ v)).sum(-1)
        ds = p * (do[r0:r0 + 1024] @ v.T - delta[r0:r0 + 1024, None])
        dq_top = max(dq_top, (ds @ k).abs().max().item() * scale)
        dk += ds.T @ q[r0:r0 + 1024]
    dk_top = dk.abs().max().item() * scale

    def d_scores(r0, r1, keys):
        p = torch.exp(scores(r0, r1, keys) - lse[r0:r1, None])
        return p * (do[r0:r1] @ v[keys].T - delta[r0:r1, None])

    return (q, k, d_scores(0, LONG_S, slice(0, LONG_KEYS)),
            d_scores(LONG_S - LONG_ROWS, LONG_S, slice(None)), dq_top, dk_top)


def _long_gate_ratio(got, want, top):
    """``_gate_ratio`` with the gate's absolute term taken from the whole
    tensor's largest |want|, ``top``, as phase 3 takes it."""
    return ((got - want).abs() / (BF16_REL * want.abs() + BF16_ABS * top)).max().item()


def test_long_dq_one_accumulator_over_8192_keys_stays_within_the_gate(one_thread):
    """dQ's accumulator sums a query row's 8192 keys (the last rows sum the
    most): its drift stays within the gate's absolute slack, 1e-5 max|dQ|,
    so no rounding of the output can take it past the gate."""
    _, k, _, ds_rows, dq_top, _ = _long_case()
    scale = 1.0 / math.sqrt(LONG_D)
    exact = (ds_rows.double() @ k.double()) * scale
    got = _accumulate(ds_rows.T.contiguous(), k) * scale
    assert (got.double() - exact).abs().max() / dq_top < 0.2e-5
    assert _long_gate_ratio(_bf16(got), exact.float(), dq_top) <= 1.0


def test_long_dk_one_head_accumulator_holds_the_gate_by_rounding_room(one_thread):
    """dK's accumulator sums one head's 8192 rows (the kernel's design since
    the GQA split): on the first keys, which sum the most rows and hold the
    largest elements, it holds phase 3's elementwise bf16 gate (the card
    measured 0.97-0.99 of it over whole tensors), but its drift at the
    largest elements passes the gate's absolute slack, 1e-5 max|dK|: the
    gate holds because bf16's rounding of those elements leaves room, not
    for every draw by construction (ROADMAP C6, closed by measurement)."""
    q, _, ds_keys, _, _, dk_top = _long_case()
    scale = 1.0 / math.sqrt(LONG_D)
    exact = (ds_keys.double().T @ q.double()) * scale
    got = _accumulate(ds_keys, q) * scale
    assert _long_gate_ratio(_bf16(got), exact.float(), dk_top) <= 1.0
    assert (got.double() - exact).abs().max() / dk_top > 1e-5


# -- the SSD: within-chunk products in TF32 hi + lo ----------------------------

def _tf32(a):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as tf32_split.cuh's round_tf32."""
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
    """a @ b as the kernel forms it with tf32_split.cuh's split_lo_truncated:
    hi parts rounded to TF32 as in ``_mm_split``, lo parts left unrounded
    for the tensor cores, which truncate them."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_single(a, b):
    """a @ b as a single TF32 pass would form it."""
    return _tf32(a) @ _tf32(b)


def _emulated_ssd_bwd(x, dt, A, B, C, dy, chunk, mm):
    """The gradient of csrc/ssd_scan_bwd.cu in float32 torch: the chunk
    states and adjoints in float32 (the FMA units), every within-chunk
    product through ``mm`` with the factors the kernel folds into an operand
    folded first: C.B^T, dy.u^T, du = X^T dy + (e_s B) G^T, dC = Y B + (e^cum
    dy) S_in, dB = Y^T C + (e_s u) G; dcum, its reverse cumulative sum and
    dA in float64."""
    b, l, h, dh = x.shape
    ds, nc, L = B.shape[-1], l // chunk, chunk
    xr = x.reshape(b, nc, L, h, dh).permute(0, 1, 3, 2, 4)      # (b,nc,h,L,dh)
    dyr = dy.reshape(b, nc, L, h, dh).permute(0, 1, 3, 2, 4)
    dtr = dt.reshape(b, nc, L, h).permute(0, 1, 3, 2)            # (b,nc,h,L)
    Br, Cr = B.reshape(b, nc, 1, L, ds), C.reshape(b, nc, 1, L, ds)
    cum = torch.cumsum(A[None, None, :, None] * dtr, dim=-1)
    u = dtr[..., None] * xr
    to_end = torch.exp(cum[..., -1:] - cum)                     # e_s
    decay = torch.exp(cum[..., -1])                              # (b,nc,h)
    inc = torch.einsum("bnhs,bnhsd,bnsk->bnhdk", to_end, u, Br[:, :, 0])
    g_loc = torch.einsum("bnht,bnhtd,bntk->bnhdk", torch.exp(cum), dyr, Cr[:, :, 0])
    S, S_in = torch.zeros_like(inc[:, 0]), []
    for n in range(nc):
        S_in.append(S)
        S = decay[:, n, :, None, None] * S + inc[:, n]
    S_in = torch.stack(S_in, 1)
    g, G = torch.zeros_like(S), [None] * nc
    for n in reversed(range(nc)):
        G[n] = g
        g = g_loc[:, n] + decay[:, n, :, None, None] * g
    G = torch.stack(G, 1)                                        # G_{n+1}
    S_next = torch.cat([S_in[:, 1:], torch.zeros_like(S_in[:, :1])], 1)

    mask = torch.ones(L, L, dtype=torch.bool).tril()
    W = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :], -torch.inf))
    CB = mm(Cr, Br.transpose(-1, -2))                            # (b,nc,1,t,s)
    DU = mm(dyr, u.transpose(-1, -2))                            # (b,nc,h,t,s)
    X, Y = CB * W, W * DU
    R = X * DU
    du_inter = mm(to_end[..., None] * Br, G.transpose(-1, -2))   # (b,nc,h,s,dh)
    du = mm(X.transpose(-1, -2), dyr) + du_inter
    dC_inter = mm(torch.exp(cum)[..., None] * dyr, S_in)         # (b,nc,h,t,ds)
    dC = mm(Y, Br) + dC_inter
    dB = mm(Y.transpose(-1, -2), Cr) + mm(to_end[..., None] * u, G)
    dcum = (R.sum(-1) + (Cr * dC_inter).sum(-1)) + (-R.sum(-2) - (u * du_inter).sum(-1))
    last = (G * S_next).sum((-2, -1))
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last[..., None]], -1).double()
    dlam = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    dA = (dtr.double() * dlam).sum((0, 1, 3)).float()
    ddt = (xr * du).sum(-1) + A[None, None, :, None] * dlam.float()
    dx = (dtr[..., None] * du).permute(0, 1, 3, 2, 4).reshape(x.shape)
    return (dx, ddt.permute(0, 1, 3, 2).reshape(dt.shape), dA,
            dB.sum(2).reshape(b, l, ds), dC.sum(2).reshape(b, l, ds))


def _ssd_inputs(b, l, h, dh, ds, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, dh)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(b, l, h)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)))).astype(np.float32)
    B = rng.normal(size=(b, l, ds)).astype(np.float32)
    C = rng.normal(size=(b, l, ds)).astype(np.float32)
    dy = rng.normal(size=(b, l, h, dh)).astype(np.float32)
    return x, dt, A, B, C, dy


# zamba2-7b's and mamba2-130m's widths (dh, ds) at chunk 128, depth cut to
# 4 chunks, then the reference's decay extremes (dt 5, A (-8, -0.001))
SSD_SPLIT_CASES = [(2, 512, 4, 64, 64, 128), (1, 512, 3, 64, 128, 128), "decay-extremes"]


@functools.lru_cache(maxsize=None)
def _ssd_case(case):
    """The case's inputs, chunk, the float64 twin's gradients and the float32
    twin's distance from them (of each gradient's max|.|)."""
    if case == "decay-extremes":
        x, _, _, B, C, dy = _ssd_inputs(1, 128, 2, 8, 16, seed=0)
        dt = np.full((1, 128, 2), 5.0, np.float32)
        ins, chunk = (x, dt, np.array([-8.0, -0.001], np.float32), B, C, dy), 64
    else:
        b, l, h, dh, ds, chunk = case
        ins = _ssd_inputs(b, l, h, dh, ds, seed=11)
    ins = tuple(map(torch.from_numpy, ins))
    exact = ssd_bwd_ref(*(t.double() for t in ins), chunk=chunk)
    twin = ssd_bwd_ref(*ins, chunk=chunk)
    return ins, chunk, exact, [_rel(t, e) for t, e in zip(twin, exact)]


def _rel(got, want):
    return (got.double() - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("mm", [_mm_split, _mm_split_lo_truncated], ids=lambda f: f.__name__)
@pytest.mark.parametrize("case", SSD_SPLIT_CASES, ids=str)
def test_ssd_bwd_split_holds_the_kernel_bounds(case, mm):
    """The split products, lo parts rounded or (as the kernel takes them)
    truncated, stay within SSD_BWD_REL of the float64 twin and within 3x the
    float32 twin's own distance from it, gradient by gradient."""
    ins, chunk, exact, twin = _ssd_case(case)
    got = _emulated_ssd_bwd(*ins, chunk, mm)
    for g, e, t in zip(got, exact, twin):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert _rel(g, e) <= SSD_BWD_REL
        assert _rel(g, e) <= TWIN_RATIO * max(t, 1e-7)


@pytest.mark.parametrize("case", SSD_SPLIT_CASES, ids=str)
def test_ssd_bwd_single_tf32_pass_misses_the_twin_ratio(case):
    """The witness: one TF32 pass per product puts some gradient further
    from the float64 twin than 3x the float32 twin's distance."""
    ins, chunk, exact, twin = _ssd_case(case)
    got = _emulated_ssd_bwd(*ins, chunk, _mm_single)
    assert max(_rel(g, e) / max(t, 1e-7) for g, e, t in zip(got, exact, twin)) > TWIN_RATIO
