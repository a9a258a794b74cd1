"""Fused SDE-step kernels for Hopper (port of ``repro.kernels.sde_step.sde_step``).

Four elementwise streams over a flat state, each a CUDA source under
``csrc/`` built by nvcc for ``sm_90a``:

* :func:`ws_stage_diag` — one Williamson 2N stage under diagonal noise,
  ``k = f*h + g*dW; delta' = a*delta + k; y' = y + b*delta'``
  (``ws_stage_diag_2d``);
* :func:`ws_stage_diag_bwd` — its VJP, ``common = ct_delta' + b*ct_y'``;
  ``(a, h, dW, g) * common`` (``ws_stage_diag_bwd_2d``);
* :func:`increment_diag` — the driver-weighted increment ``f*h + g*dW``
  (``increment_diag_2d``);
* :func:`axpy_chain` — ``y + sum_i c_i*incs[i]``, accumulated left to right
  (``axpy_chain_2d``).

Each takes tensors of any shape (operands broadcast to the first one's
shape are materialized).  On a CPU tensor it is its plain twin (:mod:`.ref`);
on a CUDA tensor it launches its kernel or raises.  Each kernel's
``launches`` counts its launches.  The prediffused and general-noise
variants of ``sde_step.py`` are still to port.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel, cuda_operands, pointer, stream_handle
from . import ref as _ref

__all__ = ["WS_STAGE_DIAG", "WS_STAGE_DIAG_BWD", "INCREMENT_DIAG",
           "AXPY_CHAIN", "MAX_INCS", "ws_stage_diag", "ws_stage_diag_bwd",
           "increment_diag", "axpy_chain"]

_P, _N, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double


def _kernel(name, args):
    return CudaKernel(name, f"{name}.cu",
                      {f"{name}_f32": args, f"{name}_f64": args})


WS_STAGE_DIAG = _kernel("ws_stage_diag", [_P] * 7 + [_N] + [_D] * 3 + [_P])
WS_STAGE_DIAG_BWD = _kernel("ws_stage_diag_bwd",
                            [_P] * 8 + [_N] + [_D] * 3 + [_P])
INCREMENT_DIAG = _kernel("increment_diag", [_P] * 4 + [_N, _D, _P])
AXPY_CHAIN = _kernel("axpy_chain", [_P, ctypes.POINTER(_P),
                                    ctypes.POINTER(_D), ctypes.c_int, _P, _N,
                                    _P])
#: Increments one axpy_chain launch takes (kMaxIncs in csrc/axpy_chain.cu).
MAX_INCS = 8
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain twin runs)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {x.device}")
    return True


def ws_stage_diag(delta, y, f, g, dW, h: float, *, a: float, b: float):
    """Fused stage; returns ``(delta', y')`` shaped like ``delta``."""
    if not _on_cuda("ws_stage_diag", delta):
        return _ref.ws_stage_diag_ref(delta, y, f, g, dW, h, a, b)
    delta, y, f, g, dW = cuda_operands(delta, y, f, g, dW)
    d_out = torch.empty_like(delta)
    y_out = torch.empty_like(delta)
    n = delta.numel()
    if n == 0:
        return d_out, y_out
    with torch.cuda.device(delta.device):
        WS_STAGE_DIAG.launch(f"ws_stage_diag_{_SUFFIX[delta.dtype]}",
                             pointer(delta), pointer(y), pointer(f), pointer(g),
                             pointer(dW), pointer(d_out), pointer(y_out), n,
                             float(h), float(a), float(b), stream_handle(delta))
    return d_out, y_out


def ws_stage_diag_bwd(ct_d2, ct_y2, g, dW, h: float, *, a: float, b: float):
    """Stage VJP; returns ``(ct_delta, ct_f, ct_g, ct_dW)`` shaped like
    ``ct_d2`` (``g`` and ``dW`` broadcast to it are materialized)."""
    if not _on_cuda("ws_stage_diag_bwd", ct_d2):
        return _ref.ws_stage_diag_bwd_ref(ct_d2, ct_y2, g, dW, h, a, b)
    ct_d2, ct_y2, g, dW = cuda_operands(ct_d2, ct_y2, g, dW)
    outs = [torch.empty_like(ct_d2) for _ in range(4)]
    n = ct_d2.numel()
    if n == 0:
        return tuple(outs)
    with torch.cuda.device(ct_d2.device):
        WS_STAGE_DIAG_BWD.launch(
            f"ws_stage_diag_bwd_{_SUFFIX[ct_d2.dtype]}", pointer(ct_d2),
            pointer(ct_y2), pointer(g), pointer(dW), *map(pointer, outs), n,
            float(h), float(a), float(b), stream_handle(ct_d2))
    return tuple(outs)


def increment_diag(f, g, dW, h: float):
    """``k = f*h + g*dW`` shaped like ``f``."""
    if not _on_cuda("increment_diag", f):
        return _ref.increment_diag_ref(f, g, dW, h)
    f, g, dW = cuda_operands(f, g, dW)
    out = torch.empty_like(f)
    n = f.numel()
    if n == 0:
        return out
    with torch.cuda.device(f.device):
        INCREMENT_DIAG.launch(f"increment_diag_{_SUFFIX[f.dtype]}", pointer(f),
                              pointer(g), pointer(dW), pointer(out), n,
                              float(h), stream_handle(f))
    return out


def axpy_chain(y, incs, coeffs):
    """``y + sum_i coeffs[i]*incs[i]`` shaped like ``y``, accumulated left to
    right; ``incs`` is a sequence of tensors, ``coeffs`` of floats."""
    if len(incs) != len(coeffs):
        raise ValueError(f"{len(incs)} increments for {len(coeffs)} "
                         "coefficients")
    if not _on_cuda("axpy_chain", y):
        return _ref.axpy_chain_ref(y, incs, coeffs)
    y, *incs = cuda_operands(y, *incs)
    n = y.numel()
    if n == 0 or not incs:
        return y.clone()
    fn = f"axpy_chain_{_SUFFIX[y.dtype]}"
    acc = y
    with torch.cuda.device(y.device):
        for lo in range(0, len(incs), MAX_INCS):
            part, cs = incs[lo:lo + MAX_INCS], coeffs[lo:lo + MAX_INCS]
            out = torch.empty_like(y)
            AXPY_CHAIN.launch(fn, pointer(acc),
                              (_P * len(part))(*[t.data_ptr() for t in part]),
                              (_D * len(cs))(*map(float, cs)), len(part),
                              pointer(out), n, stream_handle(y))
            acc = out
    return acc
