"""Causal/bidirectional GQA flash attention for Hopper (port of
``repro.kernels.flash_attention.flash_attention``).

One CUDA source, ``csrc/flash_attention.cu``, built by nvcc for ``sm_90a``:
an online-softmax pass over KV tiles in shared memory, float32 inside,
float32 or bfloat16 in and out.  On a CPU tensor :func:`flash_attention` is
its plain twin (:mod:`.ref`); on a CUDA tensor it launches the kernel or
raises.  ``KERNEL.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .._build import CudaKernel, pointer, stream_handle
from .ref import attention_ref, check_causal_shapes

__all__ = ["KERNEL", "MAX_HEAD_DIM", "flash_attention"]

_I = ctypes.c_int
_ARGS = [ctypes.c_void_p] * 4 + [_I] * 6 + [ctypes.c_double, _I, ctypes.c_void_p]
KERNEL = CudaKernel("flash_attention", "flash_attention.cu",
                    {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS})
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: Largest head dimension the kernel takes (kMaxD in the source).
MAX_HEAD_DIM = 128


def flash_attention(q, k, v, *, causal: bool = True, sm_scale=None):
    """q: (b, hq, sq, d); k, v: (b, hkv, sk, d); returns (b, hq, sq, d) in
    q's dtype.  Causal attention needs ``sq == sk``."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
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
    if q.dtype not in _SUFFIX:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k and v must share one CUDA device and dtype")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        KERNEL.launch(f"flash_attention_{_SUFFIX[q.dtype]}", pointer(q),
                      pointer(k), pointer(v), pointer(out), b, hq, hkv, sq, sk,
                      d, float(sm_scale), int(bool(causal)), stream_handle(q))
    return out
