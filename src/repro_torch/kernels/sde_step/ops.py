"""Fused SDE-step ops: autograd wrappers and pytree layer.

Port of ``repro.kernels.sde_step.ops``:

* :func:`fused_increment` / :func:`tree_increment` — ``k = f*h + g.dW``
  (diagonal, general and prediffused noise);
* :func:`fused_ws_stage` / :func:`tree_ws_stage` — increment + Williamson 2N
  register update in one pass (the same three noise modes);
* :func:`fused_axpy_chain` / :func:`tree_axpy_chain` — ``y + sum_i c_i k_i``
  (Butcher stage preparation and output combination).

Each op is a ``torch.autograd.Function`` with the reference's closed-form
backward (every op is linear in its array operands).  The diagonal stage's
backward is itself a kernel (:func:`~repro_torch.kernels.sde_step.sde_step.ws_stage_diag_bwd`,
as ``ws_stage_diag_bwd_2d`` is in the reference); the others are plain
torch, as the reference's are plain XLA (the general-noise cotangents of
``g`` and ``dW`` are the reference's einsums).  This keeps the reversible
adjoint's replay of a step differentiable through the kernels.

``noise="prediffused"`` takes ``dW`` as the pre-weighted increment
``w = g*dW`` and ignores ``g`` (None in the pytree layer): the additive fast
path of :func:`repro_torch.core.adjoint.solve`.  The coefficients are
Python floats (the scheme's constants); the step size ``h`` is the grid's
Python float, or on a realized (adaptive) grid a tensor with one value per
path shaped to broadcast against the state, which the twins broadcast and
``ws_stage_diag``/``ws_stage_diag_bwd`` take through their per-path
entries.  Neither carries a gradient: the reference drops the grid's
cotangents too.

``interpret=True``, or the :func:`force_interpret` context, runs every op
through its plain twin (:mod:`.ref`) whatever the tensor's device, as the
reference's interpret mode runs its kernel bodies off the TPU; the port's LM
ops give "interpret" the same meaning.  The twin is what a wrapper runs on a
CPU tensor anyway, so on the CPU both are bitwise the default route.
"""
from __future__ import annotations

import contextlib
import types

import torch

from ...core.pytree import flatten_up_to, tree_flatten, tree_map, tree_unflatten
from . import ref as _ref
from . import sde_step as _k

__all__ = ["force_interpret", "fused_increment", "fused_ws_stage",
           "fused_axpy_chain", "tree_increment", "tree_ws_stage",
           "tree_axpy_chain"]

_MODES = ("diagonal", "general", "prediffused")

# The kernel wrappers' plain twins, under the wrappers' names and signatures.
_TWINS = types.SimpleNamespace(
    increment_diag=_ref.increment_diag_ref,
    increment_pre=_ref.increment_pre_ref,
    increment_general=_ref.increment_general_ref,
    ws_stage_diag=lambda delta, y, f, g, dW, h, *, a, b:
        _ref.ws_stage_diag_ref(delta, y, f, g, dW, h, a, b),
    ws_stage_diag_bwd=lambda ct_d2, ct_y2, g, dW, h, *, a, b:
        _ref.ws_stage_diag_bwd_ref(ct_d2, ct_y2, g, dW, h, a, b),
    ws_stage_pre=lambda delta, y, f, w, h, *, a, b:
        _ref.ws_stage_pre_ref(delta, y, f, w, h, a, b),
    ws_stage_general=lambda delta, y, f, g, dW, h, *, a, b:
        _ref.ws_stage_general_ref(delta, y, f, g, dW, h, a, b),
    axpy_chain=_ref.axpy_chain_ref,
)

# Test hook, read at call time: run every op through its twin.
_FORCE_INTERPRET = False


@contextlib.contextmanager
def force_interpret():
    """Run every fused op through its plain twin (the reference's hook of
    the same name runs its Pallas kernels in interpret mode)."""
    global _FORCE_INTERPRET
    prev, _FORCE_INTERPRET = _FORCE_INTERPRET, True
    try:
        yield
    finally:
        _FORCE_INTERPRET = prev


def _impl(interpret: bool):
    """The kernel wrappers, or their twins under ``interpret``."""
    return _TWINS if interpret or _FORCE_INTERPRET else _k


def _step_size(h):
    """A grid's step as the ops take it: a float, or per-path values."""
    return h if isinstance(h, torch.Tensor) else float(h)


def _check_noise(noise: str) -> None:
    if noise not in _MODES:
        raise ValueError(
            f"unknown noise mode {noise!r}; valid kernel modes: 'diagonal', "
            "'general', 'prediffused'"
        )


def _einsum_outer(ct, dW):
    """``ct_g = ct (x) dW``: ``(..., d), (..., m) -> (..., d, m)``."""
    return torch.einsum("...d,...m->...dm", ct, dW)


def _einsum_gt(g, ct):
    """``ct_dW = g^T ct``: ``(..., d, m), (..., d) -> (..., m)``."""
    return torch.einsum("...dm,...d->...m", g, ct)


# -- driver-weighted increment ------------------------------------------------
# Each Function takes ``impl`` (the wrappers or their twins) as its last
# argument and keeps it for the backward.

class _IncrementDiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g, dW, h, impl):
        ctx.save_for_backward(g, dW)
        ctx.h = h
        return impl.increment_diag(f, g, dW, h)

    @staticmethod
    def backward(ctx, ct):
        g, dW = ctx.saved_tensors
        need_f, need_g, need_dw, _, _ = ctx.needs_input_grad
        return (ctx.h * ct if need_f else None,
                dW * ct if need_g else None,
                g * ct if need_dw else None,
                None, None)


class _IncrementPre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, w, h, impl):
        ctx.h = h
        return impl.increment_pre(f, w, h)

    @staticmethod
    def backward(ctx, ct):
        return ctx.h * ct, ct, None, None


class _IncrementGeneral(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g, dW, h, impl):
        ctx.save_for_backward(g, dW)
        ctx.h = h
        return impl.increment_general(f, g, dW, h)

    @staticmethod
    def backward(ctx, ct):
        g, dW = ctx.saved_tensors
        need_f, need_g, need_dw, _, _ = ctx.needs_input_grad
        return (ctx.h * ct if need_f else None,
                _einsum_outer(ct, dW) if need_g else None,
                _einsum_gt(g, ct) if need_dw else None,
                None, None)


def fused_increment(f, g, dW, h, *, noise: str, interpret: bool = False):
    """``k = f*h + g.dW`` for one leaf.  ``noise="prediffused"``: ``dW`` is
    the pre-weighted ``g*dW`` and ``g`` is ignored."""
    _check_noise(noise)
    impl = _impl(interpret)
    h = _step_size(h)
    if noise == "prediffused":
        return _IncrementPre.apply(f, dW, h, impl)
    if noise == "general":
        return _IncrementGeneral.apply(f, g, dW, h, impl)
    return _IncrementDiag.apply(f, g, dW, h, impl)


# -- fused increment + Williamson 2N stage ------------------------------------

class _WSStageDiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, y, f, g, dW, h, a, b, impl):
        ctx.save_for_backward(g, dW)
        ctx.coeffs = (h, a, b)
        ctx.impl = impl
        return impl.ws_stage_diag(delta, y, f, g, dW, h, a=a, b=b)

    @staticmethod
    def backward(ctx, ct_d2, ct_y2):
        g, dW = ctx.saved_tensors
        h, a, b = ctx.coeffs
        ct_delta, ct_f, ct_g, ct_dW = ctx.impl.ws_stage_diag_bwd(
            ct_d2, ct_y2, g, dW, h, a=a, b=b)
        return ct_delta, ct_y2, ct_f, ct_g, ct_dW, None, None, None, None


class _WSStagePre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, y, f, w, h, a, b, impl):
        ctx.coeffs = (h, a, b)
        return impl.ws_stage_pre(delta, y, f, w, h, a=a, b=b)

    @staticmethod
    def backward(ctx, ct_d2, ct_y2):
        h, a, b = ctx.coeffs
        common = ct_d2 + b * ct_y2
        # ct_w = common carries the gradient into the diffusion parameters
        # through the hoisted g*dW buffer.
        return a * common, ct_y2, h * common, common, None, None, None, None


class _WSStageGeneral(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, y, f, g, dW, h, a, b, impl):
        ctx.save_for_backward(g, dW)
        ctx.coeffs = (h, a, b)
        return impl.ws_stage_general(delta, y, f, g, dW, h, a=a, b=b)

    @staticmethod
    def backward(ctx, ct_d2, ct_y2):
        g, dW = ctx.saved_tensors
        h, a, b = ctx.coeffs
        need = ctx.needs_input_grad
        common = ct_d2 + b * ct_y2
        return (a * common, ct_y2, h * common,
                _einsum_outer(common, dW) if need[3] else None,
                _einsum_gt(g, common) if need[4] else None,
                None, None, None, None)


def fused_ws_stage(delta, y, f, g, dW, h, *, a: float, b: float, noise: str,
                   interpret: bool = False):
    """One fused Williamson stage for one leaf: returns ``(delta', y')``.
    ``noise="prediffused"``: ``dW`` is the pre-weighted ``g*dW`` and ``g``
    is ignored."""
    _check_noise(noise)
    h, a, b = _step_size(h), float(a), float(b)
    impl = _impl(interpret)
    if noise == "prediffused":
        return _WSStagePre.apply(delta, y, f, dW, h, a, b, impl)
    if noise == "general":
        return _WSStageGeneral.apply(delta, y, f, g, dW, h, a, b, impl)
    return _WSStageDiag.apply(delta, y, f, g, dW, h, a, b, impl)


# -- Butcher axpy chain -------------------------------------------------------

class _AxpyChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, impl, y, *incs):
        ctx.coeffs = coeffs
        return impl.axpy_chain(y, incs, coeffs)

    @staticmethod
    def backward(ctx, ct):
        return (None, None, ct) + tuple(c * ct for c in ctx.coeffs)


def fused_axpy_chain(y, incs, coeffs, *, interpret: bool = False):
    """``y + sum_i coeffs[i] * incs[i]`` for one leaf; ``incs`` is a sequence
    of tensors shaped like ``y``."""
    return _AxpyChain.apply(tuple(float(c) for c in coeffs), _impl(interpret),
                            y, *incs)


# -- pytree layer (what core/solvers.py calls) --------------------------------

def tree_increment(f, g, dW, h, *, noise: str, interpret: bool = False):
    """Leafwise :func:`fused_increment` over matching state pytrees;
    ``noise="prediffused"`` maps over ``(f, dW)`` only (``g`` is None)."""
    if noise == "prediffused":
        return tree_map(lambda fi, wi: fused_increment(
            fi, None, wi, h, noise=noise, interpret=interpret), f, dW)
    return tree_map(lambda fi, gi, wi: fused_increment(
        fi, gi, wi, h, noise=noise, interpret=interpret), f, g, dW)


def tree_ws_stage(delta, y, f, g, dW, h, a: float, b: float, *, noise: str,
                  interpret: bool = False):
    """Leafwise fused Williamson stage; returns the ``(delta', y')`` pytrees.
    ``noise="prediffused"`` pairs every leaf with ``g = None``."""
    d_leaves, treedef = tree_flatten(delta)
    leaves = lambda t: flatten_up_to(treedef, t)
    g_leaves = [None] * len(d_leaves) if noise == "prediffused" else leaves(g)
    pairs = [
        fused_ws_stage(di, yi, fi, gi, wi, h, a=a, b=b, noise=noise,
                       interpret=interpret)
        for di, yi, fi, gi, wi in zip(d_leaves, leaves(y), leaves(f),
                                      g_leaves, leaves(dW))
    ]
    return (tree_unflatten(treedef, [p[0] for p in pairs]),
            tree_unflatten(treedef, [p[1] for p in pairs]))


def tree_axpy_chain(y, incs, coeffs, *, interpret: bool = False):
    """Leafwise axpy chain over a list of increment pytrees matching ``y``;
    each leaf is reduced in one fused pass (no stacked copy)."""
    if not incs:
        return y
    y_leaves, treedef = tree_flatten(y)
    inc_leaves = [flatten_up_to(treedef, k) for k in incs]
    return tree_unflatten(treedef, [
        fused_axpy_chain(yi, [ks[i] for ks in inc_leaves], coeffs,
                         interpret=interpret)
        for i, yi in enumerate(y_leaves)])
