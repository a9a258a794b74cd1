"""Autograd wrapper for the Williamson 2N update (port of
``repro.kernels.williamson2n.ops``).

The update is linear in ``(delta, k, y)``, so the backward is the
reference's closed form::

    ct_delta = a * (ct_delta' + b * ct_y')
    ct_k     =      ct_delta' + b * ct_y'
    ct_y     =      ct_y'
"""
from __future__ import annotations

import torch

from .williamson2n import williamson2n

__all__ = ["williamson2n_update"]


class _Williamson2N(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, k, y, a, b):
        ctx.coeffs = (a, b)
        return williamson2n(delta, k, y, a=a, b=b)

    @staticmethod
    def backward(ctx, ct_d2, ct_y2):
        a, b = ctx.coeffs
        common = ct_d2 + b * ct_y2
        return a * common, common, ct_y2, None, None


def williamson2n_update(delta, k, y, a: float, b: float):
    """delta' = a*delta + k; y' = y + b*delta'.  Returns (delta', y')."""
    return _Williamson2N.apply(delta, k, y, float(a), float(b))
