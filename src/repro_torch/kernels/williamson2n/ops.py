"""Autograd wrapper for the Williamson 2N update (port of
``repro.kernels.williamson2n.ops``).

The update is linear in ``(delta, k, y)``, so the backward is the
reference's closed form::

    ct_delta = a * (ct_delta' + b * ct_y')
    ct_k     =      ct_delta' + b * ct_y'
    ct_y     =      ct_y'

``interpret=True`` runs the plain twin (:mod:`.ref`) whatever the tensor's
device, as the reference's interpret mode runs its kernel body off the TPU.
"""
from __future__ import annotations

import torch

from .ref import williamson2n_ref
from .williamson2n import williamson2n

__all__ = ["williamson2n_update"]


class _Williamson2N(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, k, y, a, b, interpret):
        ctx.coeffs = (a, b)
        if interpret:
            return williamson2n_ref(delta, k, y, a, b)
        return williamson2n(delta, k, y, a=a, b=b)

    @staticmethod
    def backward(ctx, ct_d2, ct_y2):
        a, b = ctx.coeffs
        common = ct_d2 + b * ct_y2
        return a * common, common, ct_y2, None, None, None


def williamson2n_update(delta, k, y, a: float, b: float, interpret: bool = False):
    """delta' = a*delta + k; y' = y + b*delta'.  Returns (delta', y')."""
    return _Williamson2N.apply(delta, k, y, float(a), float(b), bool(interpret))
