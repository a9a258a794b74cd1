"""Chunked Mamba2 SSD scan for Hopper (port of
``repro.kernels.ssd_scan.ssd_scan``).

One CUDA source, ``csrc/ssd_scan.cu``, built by nvcc for ``sm_90a``: one
block per (head, batch row) walking the chunks in order with the (dh, ds)
state in shared memory; float32 in and out.  On a CPU tensor
:func:`ssd_scan` is its plain twin (``ssd_chunked_ref``); on a CUDA tensor
it launches the kernel or raises.  ``KERNEL.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel, pointer, stream_handle
from .ref import ssd_chunked_ref

__all__ = ["KERNEL", "ssd_scan", "smem_bytes"]

_I = ctypes.c_int
KERNEL = CudaKernel("ssd_scan", "ssd_scan.cu",
                    {"ssd_scan_f32": [ctypes.c_void_p] * 6 + [_I] * 6
                     + [ctypes.c_void_p]})
_ROW_TILE = 16  # kRowTile in the source
_MAX_SMEM = 232448  # the shared memory one Hopper block may use


def smem_bytes(chunk: int, dh: int, ds: int) -> int:
    """The kernel's dynamic shared memory (its ``layout`` in the source)."""
    odd = ds + 1 if ds % 2 == 0 else ds
    return 4 * (chunk * dh + chunk * odd + chunk * ds + dh * odd
                + _ROW_TILE * chunk + 2 * chunk)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """y (b, l, h, dh) of the chunked scan from a zero state."""
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    chunk = min(chunk, l)
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)[0]
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got {x.device}")
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")
    if (dt.shape != (b, l, h) or A.shape != (h,) or B.shape != (b, l, ds)
            or C.shape != (b, l, ds)):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not match")
    for t in (x, dt, A, B, C):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("ssd_scan operands must share one CUDA device")
    if smem_bytes(chunk, dh, ds) > _MAX_SMEM:
        raise ValueError(f"chunk {chunk} with dh {dh}, ds {ds} needs "
                         f"{smem_bytes(chunk, dh, ds)} bytes of shared memory, "
                         f"more than a block has ({_MAX_SMEM})")
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        KERNEL.launch("ssd_scan_f32", pointer(x), pointer(dt), pointer(A),
                      pointer(B), pointer(C), pointer(y), b, l, h, dh, ds, chunk,
                      stream_handle(x))
    return y
