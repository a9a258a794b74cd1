"""Dispatching wrapper for the SSD scan (port of
``repro.kernels.ssd_scan.ops``).

``use_kernel="auto"`` on a CUDA tensor launches the CUDA kernel (as the
reference launches its Pallas kernel on a TPU).  Elsewhere, and for
``"never"`` and ``"interpret"``, it runs the vectorised chunked twin, as
the reference does off the TPU.  A gradient through the kernel runs the
backward kernel (``csrc/ssd_scan_bwd.cu``) on a CUDA tensor and its twin
``ssd_bwd_ref`` on a CPU tensor; the
reference, which has no backward kernel, differentiates ``ssd_chunked_ref``.

Under a mesh (DTensor inputs) each rank runs the same dispatch on its local
shard: ``x``, ``dt`` and ``A`` by head where the heads divide the mesh
axis, the batch as ``x`` is sharded, and ``B``/``C`` whole on the model
axis (one SSM group: every head reads every state column), so their
gradients come back as partial sums over the heads' ranks.
"""
from __future__ import annotations

import torch

from ...spmd import heads_layout, local_map, mesh_of, moved
from .ref import ssd_chunked_ref
from .ssd_scan import ssd_scan, ssd_scan_bwd

__all__ = ["ssd"]


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ssd_scan(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, ct):
        grads = ssd_scan_bwd(*ctx.saved_tensors, ct, chunk=ctx.chunk)
        return (*grads, None)


def ssd(x, dt, A, B, C, *, chunk: int = 128, use_kernel: str = "auto"):
    """Returns y (b, l, h, dh).  See ref.ssd_ref for semantics."""
    l = x.shape[1]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the SSD "
                         f"chunk {chunk}")
    mesh = mesh_of(x, dt, A, B, C)
    if mesh is not None:
        px = heads_layout(mesh, x, 2)
        pa, pb = moved(px, {2: 0}), moved(px, {0: 0})
        return local_map(lambda *t: ssd(*t, chunk=chunk, use_kernel=use_kernel),
                         mesh, (x, dt, A, B, C), (px, px, pa, pb, pb), px)
    if use_kernel == "auto" and x.device.type == "cuda":
        return _SSDScan.apply(x, dt, A, B, C, chunk)
    return ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)[0]
