"""Fused SDE-step kernel for Hopper: the Williamson 2N stage under diagonal noise.

Port of ``repro.kernels.sde_step.sde_step.ws_stage_diag_2d``: one pass over
the flat state computes ``k = f*h + g*dW; delta' = a*delta + k;
y' = y + b*delta'``, reading each of the five operands once and writing each
output once (``csrc/ws_stage_diag.cu``, built by nvcc for ``sm_90a``).

:func:`ws_stage_diag` takes same-shape tensors of any shape (``f``, ``g``
and ``dW`` may broadcast to the state).  On a CPU tensor it is its plain
twin (:mod:`.ref`); on a CUDA tensor it launches the kernel or raises.
``KERNEL.launches`` counts the launches.  The other TPU kernels of
``sde_step.py`` (increments, prediffused and general-noise stages, the
stage VJP, the axpy chain) are still to port.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel, cuda_operands, pointer, stream_handle
from . import ref as _ref

__all__ = ["KERNEL", "ws_stage_diag"]

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_double] * 3 \
    + [ctypes.c_void_p]
KERNEL = CudaKernel("ws_stage_diag", "ws_stage_diag.cu",
                    {"ws_stage_diag_f32": _ARGS, "ws_stage_diag_f64": _ARGS})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def ws_stage_diag(delta, y, f, g, dW, h: float, *, a: float, b: float):
    """Fused stage; returns ``(delta', y')`` shaped like ``delta``."""
    if delta.device.type == "cpu":
        return _ref.ws_stage_diag_ref(delta, y, f, g, dW, h, a, b)
    if delta.device.type != "cuda":
        raise ValueError(f"ws_stage_diag runs on CUDA or CPU tensors, got "
                         f"{delta.device}")
    delta, y, f, g, dW = cuda_operands(delta, y, f, g, dW)
    d_out = torch.empty_like(delta)
    y_out = torch.empty_like(delta)
    n = delta.numel()
    if n == 0:
        return d_out, y_out
    with torch.cuda.device(delta.device):
        KERNEL.launch(f"ws_stage_diag_{_SUFFIX[delta.dtype]}",
                      pointer(delta), pointer(y), pointer(f), pointer(g),
                      pointer(dW), pointer(d_out), pointer(y_out), n,
                      float(h), float(a), float(b), stream_handle(delta))
    return d_out, y_out
