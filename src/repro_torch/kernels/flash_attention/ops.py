"""Dispatching wrapper (port of ``repro.kernels.flash_attention.ops``).

The LM substrate calls :func:`attention`.  ``use_kernel="auto"`` on a CUDA
tensor launches the CUDA kernel (as the reference launches its Pallas
kernel on a TPU); on a CPU tensor, and for ``"never"`` and ``"interpret"``
(the reference's CPU test mode), it runs the plain twin.  A gradient through
the kernel runs the backward kernel (``csrc/flash_attention_bwd.cu``) on a
CUDA tensor and its twin ``attention_bwd_ref`` on a CPU tensor; the
reference, which has no backward kernel, differentiates ``attention_ref``.

Under a mesh (DTensor ``q``, ``k``, ``v``) each rank runs the same dispatch
on its local shard (:func:`repro_torch.spmd.gqa_map`): the batch as it is
sharded and the heads where both head counts divide the mesh axis (``H/W``
query and ``KV/W`` KV heads keep their GQA grouping); where only the query
heads divide it, ``H/W`` query heads beside the one KV head of their
group, taken from K and V whole; everything else gathered first.  The
output comes back as a DTensor in q's layout, and its gradient runs the
backward on the same shards (the KV gradients of a group summed over its
ranks).
"""
from __future__ import annotations

import torch

from ...spmd import gqa_map, mesh_of
from .flash_attention import flash_attention, flash_attention_bwd
from .ref import attention_ref

__all__ = ["attention"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, ct):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, ct, causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal=True, sm_scale=None, use_kernel: str = "auto"):
    """use_kernel: 'auto' (the kernel on a CUDA tensor), 'never', 'interpret'."""
    mesh = mesh_of(q, k, v)
    if mesh is not None:
        return gqa_map(lambda *t: attention(*t, causal=causal, sm_scale=sm_scale,
                                            use_kernel=use_kernel), mesh, q, k, v)
    if use_kernel == "auto" and q.device.type == "cuda":
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    return attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
