"""Fused SDE-step kernels for Hopper (port of ``repro.kernels.sde_step.sde_step``).

Eight kernels, each a CUDA source under ``csrc/`` built by nvcc for
``sm_90a``.  Streams over a flat state:

* :func:`ws_stage_diag` — one Williamson 2N stage under diagonal noise,
  ``k = f*h + g*dW; delta' = a*delta + k; y' = y + b*delta'``
  (``ws_stage_diag_2d``);
* :func:`ws_stage_diag_bwd` — its VJP, ``common = ct_delta' + b*ct_y'``;
  ``(a, h, dW, g) * common`` (``ws_stage_diag_bwd_2d``);
* :func:`ws_stage_pre` — the stage with a prediffused increment
  ``w = g*dW``: ``k = f*h + w`` (``ws_stage_pre_2d``);
* :func:`increment_diag` — the driver-weighted increment ``f*h + g*dW``
  (``increment_diag_2d``);
* :func:`increment_pre` — its prediffused form ``f*h + w``
  (``increment_pre_2d``);
* :func:`axpy_chain` — ``y + sum_i c_i*incs[i]``, accumulated left to right
  (``axpy_chain_2d``).

Per-row matvecs under general noise (state ``(..., d)``, diffusion
``(..., d, m)``, increment ``(..., m)``):

* :func:`increment_general` — ``f*h + g@dW`` (``increment_general_2d``);
* :func:`ws_stage_general` — that increment, then the 2N update
  (``ws_stage_general_2d``).

Each has two routes, chosen by :func:`general_route` from ``m``, the dtype
and the operands' alignment (``csrc/row_matvec.cuh``): ``"row"`` (one thread
per output, C entry ``<name>_<dtype>``) for rows of at most
``ROW_ROUTE_MAX_BYTES`` bytes, row strides off 16 bytes and unaligned
operands; ``"staged"`` (tiles of rows copied coalesced into a shared-memory
ring, entry ``<name>_<dtype>_staged``) for the rest.  Both sum ``g@dW`` in
the same order, so both equal the twin bitwise; :func:`route_launches`
splits a kernel's launches by route.

Each takes tensors of any shape (operands broadcast to the output's shape
are materialized).  On a CPU tensor it is its plain twin (:mod:`.ref`); on a
CUDA tensor it launches its kernel or raises.  Each kernel's ``launches``
counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel, cuda_operands, is_current, pointer, stream_handle
from . import ref as _ref

__all__ = ["WS_STAGE_DIAG", "WS_STAGE_DIAG_BWD", "INCREMENT_DIAG",
           "AXPY_CHAIN", "INCREMENT_PRE", "WS_STAGE_PRE", "INCREMENT_GENERAL",
           "WS_STAGE_GENERAL", "MAX_INCS", "ws_stage_diag",
           "ws_stage_diag_bwd", "increment_diag", "axpy_chain",
           "increment_pre", "ws_stage_pre", "increment_general",
           "ws_stage_general", "GENERAL_ROUTES", "ROW_ROUTE_MAX_BYTES",
           "general_route", "route_launches"]

_P, _N, _D, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int


def _kernel(name, args):
    return CudaKernel(name, f"{name}.cu",
                      {f"{name}_f32": args, f"{name}_f64": args})


WS_STAGE_DIAG = _kernel("ws_stage_diag", [_P] * 7 + [_N] + [_D] * 3 + [_P])
WS_STAGE_DIAG_BWD = _kernel("ws_stage_diag_bwd",
                            [_P] * 8 + [_N] + [_D] * 3 + [_P])
INCREMENT_DIAG = _kernel("increment_diag", [_P] * 4 + [_N, _D, _P])
#: Increments one axpy_chain launch takes (kMaxIncs in csrc/axpy_chain.cu).
MAX_INCS = 8
# One entry per dtype and chain length s: (y, out, n, stream, incs, coeffs).
AXPY_CHAIN = CudaKernel("axpy_chain", "axpy_chain.cu", {
    f"axpy_chain_{sfx}_s{s}": [_P, _P, _N, _P] + [_P] * s + [_D] * s
    for sfx in ("f32", "f64") for s in range(1, MAX_INCS + 1)})
INCREMENT_PRE = _kernel("increment_pre", [_P] * 3 + [_N, _D, _P])
WS_STAGE_PRE = _kernel("ws_stage_pre", [_P] * 6 + [_N] + [_D] * 3 + [_P])
GENERAL_ROUTES = ("row", "staged")


def _general_kernel(name, args):
    """A general-noise kernel: one C entry per dtype and route."""
    return CudaKernel(name, f"{name}.cu", {
        f"{name}_{sfx}{'_staged' if r == 'staged' else ''}": args
        for sfx in ("f32", "f64") for r in GENERAL_ROUTES})


INCREMENT_GENERAL = _general_kernel("increment_general",
                                    [_P] * 4 + [_N, _I, _I, _D, _P])
WS_STAGE_GENERAL = _general_kernel("ws_stage_general",
                                   [_P] * 7 + [_N, _I, _I] + [_D] * 3 + [_P])
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}
#: Rows of g of at most this many bytes take the row route.  Measured on an
#: H100 (``python -m repro_torch.benchmarks.general_variants``): the row
#: route is ahead up to 64-byte rows (float32 m <= 16: a warp's loads span
#: at most 2 KB, which the L1 holds), the staged route from 128 bytes on.
ROW_ROUTE_MAX_BYTES = 64


def general_route(m: int, dtype: torch.dtype, aligned: bool) -> str:
    """The route a CUDA general-noise launch takes for rows of ``m`` values
    of ``dtype`` (float32 or float64), ``aligned`` when g and dW both start
    on 16 bytes: ``"staged"`` for rows longer than ``ROW_ROUTE_MAX_BYTES``
    whose stride is a multiple of 16 bytes, with aligned operands (what its
    16-byte copies need); ``"row"`` for the rest."""
    row_bytes = m * _ITEMSIZE[dtype]
    if row_bytes <= ROW_ROUTE_MAX_BYTES or row_bytes % 16 or not aligned:
        return "row"
    return "staged"


def route_launches(kernel: CudaKernel) -> dict:
    """``{route: launches}`` of a general-noise kernel, from its entries'
    counts (read by difference, as ``entry_launches``)."""
    return {r: sum(n for fn, n in kernel.entry_launches.items()
                   if fn.endswith("_staged") == (r == "staged"))
            for r in GENERAL_ROUTES}


def _general_entry(name: str, g: torch.Tensor, dW: torch.Tensor, m: int) -> str:
    aligned = g.data_ptr() % 16 == 0 and dW.data_ptr() % 16 == 0
    staged = general_route(m, g.dtype, aligned) == "staged"
    return f"{name}_{_SUFFIX[g.dtype]}{'_staged' if staged else ''}"


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain twin runs)."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {x.device}")
    return False


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
    right; ``incs`` is a sequence of tensors, ``coeffs`` of floats.  On CUDA
    a chain of ``s <= MAX_INCS`` increments is one launch of the kernel built
    for its ``s`` (entry ``axpy_chain_<dtype>_s<s>``); a longer chain is
    consecutive launches of at most ``MAX_INCS`` increments, in order, each
    taking the last one's output as its ``y``."""
    if len(incs) != len(coeffs):
        raise ValueError(f"{len(incs)} increments for {len(coeffs)} "
                         "coefficients")
    if not _on_cuda("axpy_chain", y):
        return _ref.axpy_chain_ref(y, incs, coeffs)
    if len(incs) > MAX_INCS:
        head = axpy_chain(y, incs[:MAX_INCS], coeffs[:MAX_INCS])
        return axpy_chain(head, incs[MAX_INCS:], coeffs[MAX_INCS:])
    if not is_current(y):
        with torch.cuda.device(y.device):
            return axpy_chain(y, incs, coeffs)
    y, *incs = cuda_operands(y, *incs)
    n = y.numel()
    if n == 0 or not incs:
        return y.clone()
    out = torch.empty_like(y)
    AXPY_CHAIN.launch(f"axpy_chain_{_SUFFIX[y.dtype]}_s{len(incs)}", y.data_ptr(),
                      out.data_ptr(), n, stream_handle(y),
                      *[t.data_ptr() for t in incs], *map(float, coeffs))
    return out


def increment_pre(f, w, h: float):
    """``k = f*h + w`` shaped like ``f`` (``w`` is the prediffused ``g*dW``)."""
    if not _on_cuda("increment_pre", f):
        return _ref.increment_pre_ref(f, w, h)
    if not is_current(f):
        with torch.cuda.device(f.device):
            return increment_pre(f, w, h)
    f, w = cuda_operands(f, w)
    out = torch.empty_like(f)
    n = f.numel()
    if n == 0:
        return out
    INCREMENT_PRE.launch(f"increment_pre_{_SUFFIX[f.dtype]}", f.data_ptr(),
                         w.data_ptr(), out.data_ptr(), n, float(h), stream_handle(f))
    return out


def ws_stage_pre(delta, y, f, w, h: float, *, a: float, b: float):
    """Prediffused fused stage; returns ``(delta', y')`` shaped like ``delta``."""
    if not _on_cuda("ws_stage_pre", delta):
        return _ref.ws_stage_pre_ref(delta, y, f, w, h, a, b)
    delta, y, f, w = cuda_operands(delta, y, f, w)
    d_out = torch.empty_like(delta)
    y_out = torch.empty_like(delta)
    n = delta.numel()
    if n == 0:
        return d_out, y_out
    with torch.cuda.device(delta.device):
        WS_STAGE_PRE.launch(f"ws_stage_pre_{_SUFFIX[delta.dtype]}",
                            pointer(delta), pointer(y), pointer(f), pointer(w),
                            pointer(d_out), pointer(y_out), n, float(h),
                            float(a), float(b), stream_handle(delta))
    return d_out, y_out


def _general_shapes(f, g, dW):
    """The row layout of a general-noise launch: ``(batch, d, m)`` with the
    leading axes of ``f (..., d)``, ``g (..., d, m)`` and ``dW (..., m)``
    broadcast together."""
    if f.dim() < 1 or g.dim() < 2 or dW.dim() < 1:
        raise ValueError(
            f"general noise takes f (..., d), g (..., d, m), dW (..., m); got "
            f"{tuple(f.shape)}, {tuple(g.shape)}, {tuple(dW.shape)}")
    d, m = f.shape[-1], g.shape[-1]
    if g.shape[-2] != d or dW.shape[-1] != m or m < 1:
        raise ValueError(
            f"general noise: g {tuple(g.shape)} is not (..., d={d}, m) with "
            f"m = dW's last axis ({dW.shape[-1]}) >= 1")
    batch = torch.broadcast_shapes(f.shape[:-1], g.shape[:-2], dW.shape[:-1])
    return tuple(batch), d, m


def increment_general(f, g, dW, h: float):
    """``k = f*h + g@dW`` per row: ``(..., d)`` from ``f (..., d)``,
    ``g (..., d, m)`` and ``dW (..., m)``."""
    if not _on_cuda("increment_general", f):
        return _ref.increment_general_ref(f, g, dW, h)
    if not is_current(f):
        with torch.cuda.device(f.device):
            return increment_general(f, g, dW, h)
    batch, d, m = _general_shapes(f, g, dW)
    f, g, dW = cuda_operands(f, g, dW, shapes=(batch + (d,), batch + (d, m),
                                               batch + (m,)))
    out = torch.empty_like(f)
    rows = f.numel() // d
    if rows == 0:
        return out
    INCREMENT_GENERAL.launch(
        _general_entry("increment_general", g, dW, m), f.data_ptr(), g.data_ptr(),
        dW.data_ptr(), out.data_ptr(), rows, d, m, float(h), stream_handle(f))
    return out


def ws_stage_general(delta, y, f, g, dW, h: float, *, a: float, b: float):
    """General-noise fused stage; returns ``(delta', y')`` shaped
    ``(..., d)`` like the state."""
    if not _on_cuda("ws_stage_general", delta):
        return _ref.ws_stage_general_ref(delta, y, f, g, dW, h, a, b)
    if not is_current(delta):
        with torch.cuda.device(delta.device):
            return ws_stage_general(delta, y, f, g, dW, h, a=a, b=b)
    batch, d, m = _general_shapes(f, g, dW)
    batch = tuple(torch.broadcast_shapes(batch, delta.shape[:-1],
                                         y.shape[:-1]))
    state = batch + (d,)
    delta, y, f, g, dW = cuda_operands(
        delta, y, f, g, dW,
        shapes=(state, state, state, batch + (d, m), batch + (m,)))
    d_out = torch.empty_like(delta)
    y_out = torch.empty_like(delta)
    rows = delta.numel() // d
    if rows == 0:
        return d_out, y_out
    WS_STAGE_GENERAL.launch(
        _general_entry("ws_stage_general", g, dW, m), delta.data_ptr(), y.data_ptr(),
        f.data_ptr(), g.data_ptr(), dW.data_ptr(), d_out.data_ptr(), y_out.data_ptr(),
        rows, d, m, float(h), float(a), float(b), stream_handle(delta))
    return d_out, y_out
