"""Dispatching wrapper (port of ``repro.kernels.flash_attention.ops``).

The LM substrate calls :func:`attention`.  ``use_kernel="auto"`` on a CUDA
tensor launches the CUDA kernel (as the reference launches its Pallas
kernel on a TPU); on a CPU tensor, and for ``"never"`` and ``"interpret"``
(the reference's CPU test mode), it runs the plain twin.  The kernel has no
backward (neither has the reference's): a gradient through it raises
:class:`~repro_torch.device.NotYetPorted` instead of being dropped.
"""
from __future__ import annotations

import torch

from ...device import not_yet_ported
from .flash_attention import flash_attention
from .ref import attention_ref

__all__ = ["attention"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, ct):
        raise not_yet_ported("the gradient of the flash_attention kernel "
                             "(training through the LM)")


def attention(q, k, v, *, causal=True, sm_scale=None, use_kernel: str = "auto"):
    """use_kernel: 'auto' (the kernel on a CUDA tensor), 'never', 'interpret'."""
    if use_kernel == "auto" and q.device.type == "cuda":
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    return attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
