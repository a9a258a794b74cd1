"""Dispatching wrapper for the SSD scan (port of
``repro.kernels.ssd_scan.ops``).

``use_kernel="auto"`` on a CUDA tensor launches the CUDA kernel (as the
reference launches its Pallas kernel on a TPU).  Elsewhere, and for
``"never"`` and ``"interpret"``, it runs the vectorised chunked twin, as
the reference does off the TPU.  The kernel has no backward (neither has
the reference's): a gradient through it raises
:class:`~repro_torch.device.NotYetPorted`.
"""
from __future__ import annotations

import torch

from ...device import not_yet_ported
from .ref import ssd_chunked_ref
from .ssd_scan import ssd_scan

__all__ = ["ssd"]


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        return ssd_scan(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, ct):
        raise not_yet_ported("the gradient of the ssd_scan kernel (training "
                             "through the LM)")


def ssd(x, dt, A, B, C, *, chunk: int = 128, use_kernel: str = "auto"):
    """Returns y (b, l, h, dh).  See ref.ssd_ref for semantics."""
    l = x.shape[1]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the SSD "
                         f"chunk {chunk}")
    if use_kernel == "auto" and x.device.type == "cuda":
        return _SSDScan.apply(x, dt, A, B, C, chunk)
    return ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)[0]
