"""Causal/bidirectional GQA flash attention for Hopper (port of
``repro.kernels.flash_attention.flash_attention``).

One CUDA source, ``csrc/flash_attention.cu``, built by nvcc for ``sm_90a``,
with three routes chosen by :func:`route` from the dtype and head dim alone:

* ``"wgmma"`` — bf16 with ``d % 8 == 0`` (TMA's 16-byte row stride) and
  ``d <= 128``: a producer warp feeds a ring of K/V tiles through TMA and two
  consumer warpgroups run both products on the tensor cores (``wgmma``);
* ``"mma_tf32"`` — float32: both products on the TF32 tensor cores
  (``mma.sync``), float32-exact by splitting each operand into TF32 hi + lo
  parts (three passes; a single TF32 pass would change the float32
  function), K/V tiles fed by a ``cp.async`` ring;
* ``"simt"`` — bf16 with any other d: an online-softmax pass on the float32
  FMA units.

On a CPU tensor :func:`flash_attention` is its plain twin (:mod:`.ref`); on a
CUDA tensor it launches the route's kernel or raises.  ``KERNEL.launches``
counts the launches, ``ROUTE_LAUNCHES`` splits them by route.

:func:`flash_attention_bwd` is the gradient, from a second source,
``csrc/flash_attention_bwd.cu`` (``KERNEL_BWD``): three launches (row
statistics, dK/dV, dQ; under GQA on the wgmma route a fourth sums each
group's per-query-head dK/dV in order) behind one C entry per route.  :func:`route` picks
it as for the forward: ``"wgmma"`` (bf16 with ``d % 8 == 0``, ``d <= 128``)
runs every product on the tensor cores, P and dS split into bf16 hi + lo;
float32 and other bf16 take ``"simt"``, the float32 FMA units.
``BWD_ROUTE_LAUNCHES`` counts the calls by route.  On a CPU tensor it is
its twin :func:`~.ref.attention_bwd_ref`.

Both take the reference's keywords: ``interpret=True`` runs the plain twin
on any device (the reference's Pallas interpret mode, which its CPU tests
use); ``block_q`` and ``block_k`` are checked and otherwise unused, since
each Hopper route fixes its tiles by its shared-memory layout.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .._build import CudaKernel, pointer, stream_handle
from .ref import attention_bwd_ref, attention_ref, check_causal_shapes

__all__ = ["BWD_ROUTE_LAUNCHES", "KERNEL", "KERNEL_BWD", "MAX_HEAD_DIM", "ROUTE_LAUNCHES",
           "bwd_route", "bwd_wgmma_smem_bytes", "flash_attention", "flash_attention_bwd",
           "route", "tf32_smem_bytes", "wgmma_smem_bytes"]

_I = ctypes.c_int
_ARGS = [ctypes.c_void_p] * 4 + [_I] * 6 + [ctypes.c_double, _I, ctypes.c_void_p]
_ENTRY = {"wgmma": {torch.bfloat16: "flash_attention_bf16_wgmma"},
          "mma_tf32": {torch.float32: "flash_attention_f32_tf32"},
          "simt": {torch.bfloat16: "flash_attention_bf16"}}
KERNEL = CudaKernel("flash_attention", "flash_attention.cu",
                    {fn: _ARGS for fns in _ENTRY.values() for fn in fns.values()})
_BWD_ENTRY = {"wgmma": {torch.bfloat16: "flash_attention_bwd_bf16_wgmma"},
              "simt": {torch.float32: "flash_attention_bwd_f32",
                       torch.bfloat16: "flash_attention_bwd_bf16"}}
_BWD_ARGS = [ctypes.c_void_p] * 10 + [_I] * 6 + [ctypes.c_double, _I, ctypes.c_void_p]
# the wgmma entry takes, after the row statistics, the float32 scratch for
# each query head's share of dK and dV under GQA (summed over a group after)
_BWD_WGMMA_ARGS = [ctypes.c_void_p] * 11 + [_I] * 6 + [ctypes.c_double, _I, ctypes.c_void_p]
KERNEL_BWD = CudaKernel("flash_attention_bwd", "flash_attention_bwd.cu",
                        {fn: _BWD_WGMMA_ARGS if path == "wgmma" else _BWD_ARGS
                         for path, fns in _BWD_ENTRY.items() for fn in fns.values()})
#: Launches by route, counted beside ``KERNEL.launches``.
ROUTE_LAUNCHES = {"wgmma": 0, "mma_tf32": 0, "simt": 0}
#: Calls of the backward's C entry by route, beside ``KERNEL_BWD.launches``.
BWD_ROUTE_LAUNCHES = {"wgmma": 0, "simt": 0}
#: Largest head dimension the kernel takes (kMaxD in the source).
MAX_HEAD_DIM = 128
# The wgmma route's tiles (kWgBlockQ, kWgBlockK, kWgStages in the source).
_BLOCK_Q, _BLOCK_K, _STAGES = 128, 128, 2
# The backward wgmma route's tiles (kBwOwn, kBwTile, kBwStages in
# flash_attention_bwd.cu): a block's own rows, the rows it streams, the ring.
_BW_OWN, _BW_TILE, _BW_STAGES = 128, 64, 2
# The mma_tf32 route's tiles (kTfBlockQ, kTfBlockK, kTfStages, kTfQInRegs).
_TF_BLOCK_Q, _TF_BLOCK_K, _TF_STAGES, _TF_Q_IN_REGS = 128, 64, 2, False


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call takes: ``"mma_tf32"`` for float32, ``"wgmma"``
    for bf16 with ``d % 8 == 0`` and ``d <= 128``, ``"simt"`` for other bf16."""
    if dtype == torch.float32:
        return "mma_tf32"
    return ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and d <= MAX_HEAD_DIM
            else "simt")


def wgmma_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the wgmma route at head dim ``d`` (its
    ``kWgSmemBytes``): the q tile and the K/V ring, each row padded to 128
    bf16 columns (two 128-byte swizzle atoms), the mbarriers, and 1024
    bytes to align the tiles to the swizzle's period."""
    if route(torch.bfloat16, d) != "wgmma":
        raise ValueError(f"head dim {d} does not take the wgmma route")
    row = 2 * MAX_HEAD_DIM
    n_barriers = 1 + 3 * _STAGES
    return _BLOCK_Q * row + 2 * _STAGES * _BLOCK_K * row + 8 * n_barriers + 1024


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernel a CUDA call takes: ``"wgmma"`` where the forward
    takes it, ``"simt"`` for float32 and other bf16."""
    return "wgmma" if route(dtype, d) == "wgmma" else "simt"


def bwd_wgmma_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the backward's wgmma route at head dim ``d``
    (its ``kBwSmemBytes``, one size for its three launches): two own tiles
    of 128 rows (K and V, or Q and dO), a ring of stages of two 64-row tiles
    (Q and dO, or K and V) with a q tile's lse and D, every row padded to
    128 bf16 columns, the mbarriers, and 1024 bytes of alignment."""
    if bwd_route(torch.bfloat16, d) != "wgmma":
        raise ValueError(f"head dim {d} does not take the backward's wgmma route")
    row = 2 * MAX_HEAD_DIM
    n_barriers = 1 + 2 * _BW_STAGES
    return (2 * _BW_OWN * row + _BW_STAGES * (2 * _BW_TILE * row + 2 * 4 * _BW_TILE)
            + 8 * n_barriers + 1024)


def tf32_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the mma_tf32 route at head dim ``d`` (its
    ``tf_smem_bytes``): the K/V ring and the q tile, d padded to a multiple
    of 16 and rows strided 8 (mod 32) floats for K and Q, 4 (mod 8) for V."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    dp = -(-d // 16) * 16
    ldk = dp + 8 if dp % 32 == 0 else dp + 24
    ldv = dp + 4
    q_tile = 0 if _TF_Q_IN_REGS else _TF_BLOCK_Q * ldk
    return 4 * (_TF_STAGES * _TF_BLOCK_K * (ldk + ldv) + q_tile)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` at a 16-byte aligned address, as TMA reads it (a contiguous view
    at an odd offset is copied)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v, causal, sm_scale, *others) -> float:
    """Checks the operands of a CUDA launch (``others`` shaped as q, in its
    dtype); returns the softmax scale."""
    b, hq, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    check_causal_shapes(sq, sk, causal)
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} KV heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for t in (k, v) + others:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("the operands must share one CUDA device and dtype")
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f"an operand of shape {tuple(t.shape)} where q's "
                             f"{tuple(q.shape)} is expected")
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _check_blocks(block_q, block_k) -> None:
    for name, n in (("block_q", block_q), ("block_k", block_k)):
        if isinstance(n, bool) or not isinstance(n, int) or n < 1:
            raise ValueError(f"{name} must be a positive int, got {n!r}")


def flash_attention(q, k, v, *, causal: bool = True, sm_scale=None, block_q: int = 128,
                    block_k: int = 128, interpret: bool = False):
    """q: (b, hq, sq, d); k, v: (b, hkv, sk, d); returns (b, hq, sq, d) in
    q's dtype.  Causal attention needs ``sq == sk``.  ``interpret`` runs the
    plain twin; ``block_q`` / ``block_k`` are the reference's tile sizes,
    checked and unused (each route's tiles are fixed)."""
    _check_blocks(block_q, block_k)
    if interpret or q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    sm_scale = _check(q, k, v, causal, sm_scale)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sk == 0:  # no key: every softmax sum is 0, divided by 1
        return out.zero_()
    path = route(q.dtype, d)
    if path == "wgmma":
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    with torch.cuda.device(q.device):
        KERNEL.launch(_ENTRY[path][q.dtype], pointer(q), pointer(k), pointer(v),
                      pointer(out), b, hq, hkv, sq, sk, d, float(sm_scale),
                      int(bool(causal)), stream_handle(q))
    ROUTE_LAUNCHES[path] += 1
    return out


def flash_attention_bwd(q, k, v, out, d_out, *, causal: bool = True, sm_scale=None,
                        interpret: bool = False):
    """The gradient ``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k,
    v)``, whose output was ``out``, against the cotangent ``d_out`` (shaped
    as q), in the inputs' dtype.  Causal attention needs ``sq == sk``;
    ``interpret`` runs the plain twin."""
    if interpret or q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, d_out, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU tensors, got {q.device}")
    sm_scale = _check(q, k, v, causal, sm_scale, out, d_out)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    q, k, v, out, d_out = (t.contiguous() for t in (q, k, v, out, d_out))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    path = bwd_route(q.dtype, d)
    # per query row: the log-sum-exp of its scores and rowsum(dO * O); the
    # wgmma route pads each head's rows to its 128-row tiles
    rows = -(-sq // _BW_OWN) * _BW_OWN if path == "wgmma" else sq
    lse = torch.empty(b, hq, rows, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    stats = [pointer(lse), pointer(delta)]
    if path == "wgmma":
        q, k, v, d_out = _aligned(q), _aligned(k), _aligned(v), _aligned(d_out)
        # each query head's share of dK and dV in float32 (GQA), summed over
        # its group after
        part = (torch.empty(b * hq, 2, sk, d, dtype=torch.float32, device=q.device)
                if hq > hkv else None)
        stats.append(None if part is None else pointer(part))
    with torch.cuda.device(q.device):
        KERNEL_BWD.launch(_BWD_ENTRY[path][q.dtype], pointer(q), pointer(k), pointer(v),
                          pointer(out), pointer(d_out), pointer(dq), pointer(dk),
                          pointer(dv), *stats, b, hq, hkv, sq, sk, d, sm_scale,
                          int(bool(causal)), stream_handle(q))
    BWD_ROUTE_LAUNCHES[path] += 1
    return dq, dk, dv
