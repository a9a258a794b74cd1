"""Fused SDE-step ops: autograd wrappers and pytree layer.

Port of ``repro.kernels.sde_step.ops`` for diagonal noise and the axpy chain:

* :func:`fused_increment` / :func:`tree_increment` — ``k = f*h + g*dW``;
* :func:`fused_ws_stage` / :func:`tree_ws_stage` — increment + Williamson 2N
  register update in one pass;
* :func:`fused_axpy_chain` / :func:`tree_axpy_chain` — ``y + sum_i c_i k_i``
  (Butcher stage preparation and output combination).

Each op is a ``torch.autograd.Function`` with the reference's closed-form
backward (every op is linear in its array operands).  The stage's backward
is itself a kernel (:func:`~repro_torch.kernels.sde_step.sde_step.ws_stage_diag_bwd`,
as ``ws_stage_diag_bwd_2d`` is in the reference); the other two backwards
are plain torch, as the reference's are plain XLA.  This keeps the
reversible adjoint's replay of a step differentiable through the kernels.

The step size ``h`` and the coefficients are Python floats (the grid's
static step and the scheme's constants), so they carry no gradient — the
reference drops the grid's cotangents too.  ``noise="general"`` and
``"prediffused"`` name TPU kernels still to port and raise.
"""
from __future__ import annotations

import torch

from ...core.pytree import flatten_up_to, tree_flatten, tree_map, tree_unflatten
from . import sde_step as _k

__all__ = ["fused_increment", "fused_ws_stage", "fused_axpy_chain",
           "tree_increment", "tree_ws_stage", "tree_axpy_chain"]

_UNPORTED_STAGE = {
    "general": "sde_step.py::ws_stage_general_2d",
    "prediffused": "sde_step.py::ws_stage_pre_2d",
}
_UNPORTED_INCREMENT = {
    "general": "sde_step.py::increment_general_2d",
    "prediffused": "sde_step.py::increment_pre_2d",
}


def _check_noise(noise: str, unported) -> None:
    if noise in unported:
        raise ValueError(
            f"noise={noise!r} needs the TPU kernel {unported[noise]}, which "
            "is not yet ported to repro_torch; only diagonal noise is"
        )
    if noise != "diagonal":
        raise ValueError(
            f"unknown noise mode {noise!r}; valid kernel modes: 'diagonal', "
            "'general', 'prediffused'"
        )


# -- driver-weighted increment ------------------------------------------------

class _IncrementDiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g, dW, h):
        ctx.save_for_backward(g, dW)
        ctx.h = h
        return _k.increment_diag(f, g, dW, h)

    @staticmethod
    def backward(ctx, ct):
        g, dW = ctx.saved_tensors
        need_f, need_g, need_dw, _ = ctx.needs_input_grad
        return (ctx.h * ct if need_f else None,
                dW * ct if need_g else None,
                g * ct if need_dw else None,
                None)


def fused_increment(f, g, dW, h, *, noise: str):
    """``k = f*h + g*dW`` for one leaf (diagonal noise)."""
    _check_noise(noise, _UNPORTED_INCREMENT)
    return _IncrementDiag.apply(f, g, dW, float(h))


# -- fused increment + Williamson 2N stage ------------------------------------

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
        ct_delta, ct_f, ct_g, ct_dW = _k.ws_stage_diag_bwd(
            ct_d2, ct_y2, g, dW, h, a=a, b=b)
        return ct_delta, ct_y2, ct_f, ct_g, ct_dW, None, None, None


def fused_ws_stage(delta, y, f, g, dW, h, *, a: float, b: float, noise: str):
    """One fused Williamson stage for one leaf: returns ``(delta', y')``."""
    _check_noise(noise, _UNPORTED_STAGE)
    return _WSStageDiag.apply(delta, y, f, g, dW, float(h), float(a), float(b))


# -- Butcher axpy chain -------------------------------------------------------

class _AxpyChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, y, *incs):
        ctx.coeffs = coeffs
        return _k.axpy_chain(y, incs, coeffs)

    @staticmethod
    def backward(ctx, ct):
        return (None, ct) + tuple(c * ct for c in ctx.coeffs)


def fused_axpy_chain(y, incs, coeffs):
    """``y + sum_i coeffs[i] * incs[i]`` for one leaf; ``incs`` is a sequence
    of tensors shaped like ``y``."""
    return _AxpyChain.apply(tuple(float(c) for c in coeffs), y, *incs)


# -- pytree layer (what core/solvers.py calls) --------------------------------

def tree_increment(f, g, dW, h, *, noise: str):
    """Leafwise :func:`fused_increment` over matching state pytrees."""
    return tree_map(lambda fi, gi, wi: fused_increment(fi, gi, wi, h, noise=noise),
                    f, g, dW)


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


def tree_axpy_chain(y, incs, coeffs):
    """Leafwise axpy chain over a list of increment pytrees matching ``y``;
    each leaf is reduced in one fused pass (no stacked copy)."""
    if not incs:
        return y
    y_leaves, treedef = tree_flatten(y)
    inc_leaves = [flatten_up_to(treedef, k) for k in incs]
    return tree_unflatten(treedef, [
        fused_axpy_chain(yi, [ks[i] for ks in inc_leaves], coeffs)
        for i, yi in enumerate(y_leaves)])
