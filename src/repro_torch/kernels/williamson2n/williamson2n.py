"""Williamson 2N update kernel for Hopper: ``delta' = a*delta + k;
y' = y + b*delta'`` with the increment ``k`` given.

Port of ``repro.kernels.williamson2n.williamson2n.williamson2n_2d``: one pass
reading ``delta``, ``k`` and ``y`` once and writing both outputs once
(``csrc/williamson2n.cu``, built by nvcc for ``sm_90a``).  On a CPU tensor
:func:`williamson2n` is its plain twin (:mod:`.ref`); on a CUDA tensor it
launches the kernel or raises.  ``KERNEL.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel, cuda_operands, pointer, stream_handle
from .ref import williamson2n_ref

__all__ = ["KERNEL", "williamson2n"]

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_double] * 2 \
    + [ctypes.c_void_p]
KERNEL = CudaKernel("williamson2n", "williamson2n.cu",
                    {"williamson2n_f32": _ARGS, "williamson2n_f64": _ARGS})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def williamson2n(delta, k, y, *, a: float, b: float):
    """Fused 2N update; returns ``(delta', y')`` shaped like ``delta``."""
    if delta.device.type == "cpu":
        return williamson2n_ref(delta, k, y, a, b)
    if delta.device.type != "cuda":
        raise ValueError(f"williamson2n runs on CUDA or CPU tensors, got "
                         f"{delta.device}")
    delta, k, y = cuda_operands(delta, k, y)
    d_out = torch.empty_like(delta)
    y_out = torch.empty_like(delta)
    n = delta.numel()
    if n == 0:
        return d_out, y_out
    with torch.cuda.device(delta.device):
        KERNEL.launch(f"williamson2n_{_SUFFIX[delta.dtype]}",
                      pointer(delta), pointer(k), pointer(y), pointer(d_out),
                      pointer(y_out), n, float(a), float(b),
                      stream_handle(delta))
    return d_out, y_out
