"""Fused SDE-step ops: autograd wrapper and pytree layer (diagonal stage).

Port of the ``ws_stage`` part of ``repro.kernels.sde_step.ops``:

* :func:`fused_ws_stage` — one leaf; a ``torch.autograd.Function`` around
  :func:`~repro_torch.kernels.sde_step.sde_step.ws_stage_diag` whose
  backward is the reference's closed form (``ops.py:236-244``), in plain
  torch until the stage-VJP kernel is ported;
* :func:`tree_ws_stage` — leafwise over matching state pytrees, unzipped by
  explicit flatten/unflatten (a tuple state is itself a pytree node).

The step size ``h`` and the coefficients ``a``, ``b`` are Python floats
(the grid's static step and the scheme's constants), so they carry no
gradient.  ``noise="general"`` and ``"prediffused"`` name TPU kernels still
to port and raise.
"""
from __future__ import annotations

import torch

from ...core.pytree import flatten_up_to, tree_flatten, tree_unflatten
from . import sde_step as _k

__all__ = ["fused_ws_stage", "tree_ws_stage"]

_UNPORTED = {
    "general": "sde_step.py::ws_stage_general_2d",
    "prediffused": "sde_step.py::ws_stage_pre_2d",
}


class _WSStageDiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, y, f, g, dW, h, a, b):
        ctx.save_for_backward(g, dW)
        ctx.coeffs = (h, a, b)
        return _k.ws_stage_diag(delta, y, f, g, dW, h, a=a, b=b)

    @staticmethod
    def backward(ctx, ct_d2, ct_y2):
        g, dW = ctx.saved_tensors
        h, a, b = ctx.coeffs
        common = ct_d2 + b * ct_y2
        return (a * common, ct_y2, h * common, dW * common, g * common,
                None, None, None)


def fused_ws_stage(delta, y, f, g, dW, h, *, a: float, b: float, noise: str):
    """One fused Williamson stage for one leaf: returns ``(delta', y')``."""
    if noise in _UNPORTED:
        raise ValueError(
            f"noise={noise!r} needs the TPU kernel {_UNPORTED[noise]}, which "
            "is not yet ported to repro_torch; only the diagonal stage is"
        )
    if noise != "diagonal":
        raise ValueError(
            f"unknown noise mode {noise!r}; valid kernel modes: 'diagonal', "
            "'general', 'prediffused'"
        )
    return _WSStageDiag.apply(delta, y, f, g, dW, float(h), float(a), float(b))


def tree_ws_stage(delta, y, f, g, dW, h, a: float, b: float, *, noise: str):
    """Leafwise fused Williamson stage; returns the ``(delta', y')`` pytrees."""
    d_leaves, treedef = tree_flatten(delta)
    leaves = lambda t: flatten_up_to(treedef, t)
    pairs = [
        fused_ws_stage(di, yi, fi, gi, wi, h, a=a, b=b, noise=noise)
        for di, yi, fi, gi, wi in zip(d_leaves, leaves(y), leaves(f),
                                      leaves(g), leaves(dW))
    ]
    return (tree_unflatten(treedef, [p[0] for p in pairs]),
            tree_unflatten(treedef, [p[1] for p in pairs]))
