"""EES residual-stream integration: the paper's technique applied to LM depth
(port of ``repro.models.reversible``).

A pre-norm transformer layer is ``y_out = y + F(y)`` with
``F(y) = attn(y) + mlp(y + attn(y))``: an Euler step of the depth-ODE
``dy/dt = F_l(y)`` with step 1.  Replacing Euler with one EES(2,5) 2N step per
layer gives a near-reversible depth integration: the backward pass
reconstructs each layer's input from its output (``Phi_{-h}``, accurate to
O(h^6)) instead of storing it, so the activation memory of training is O(1)
in depth: the paper's reversible adjoint with depth in the role of time.

This changes the function computed (three stage evaluations per layer,
continuous-depth semantics) and is opt-in, as in the reference.

``layers`` is a sequence of per-layer parameter containers: an
``nn.ModuleList`` such as :class:`~repro_torch.models.LMParams`'s
``layers``, or a list of dicts of tensors (the reference's stacked leaves
split along their layer axis).  ``block_fn(layer_params, y) -> F(y)`` must be
free of side effects.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from ..core.pytree import tree_flatten, tree_unflatten
from ..core.williamson import EES25_2N

__all__ = ["ees_depth_solve", "euler_depth_solve"]


def _ees_step(block_fn, lp, y, step: float):
    """One EES(2,5) 2N step of dy/dt = block_fn(lp, y)."""
    delta = torch.zeros_like(y)
    for a, b in zip(EES25_2N.A, EES25_2N.B):
        k = step * block_fn(lp, y)
        delta = a * delta + k
        y = y + b * delta
    return y


def euler_depth_solve(block_fn: Callable, layers: Sequence, y0, step: float = 1.0):
    """Vanilla residual stack (Euler): y <- y + step * F_l(y).  Reference."""
    y = y0
    for lp in layers:
        y = y + step * block_fn(lp, y)
    return y


def _leaves(lp):
    """The tensors of one layer's parameters, in a fixed order."""
    if isinstance(lp, nn.Module):
        return list(lp.parameters())
    return tree_flatten(lp)[0]


def _replay_layer(lp):
    """``lp`` with leaves the replay can differentiate, and those leaves: a
    module's own parameters, or detached copies of a tree's tensors."""
    if isinstance(lp, nn.Module):
        return lp, list(lp.parameters())
    leaves, treedef = tree_flatten(lp)
    fresh = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
    return tree_unflatten(treedef, fresh), fresh


class _ReversibleDepth(torch.autograd.Function):
    """EES(2,5) over depth with the reversible adjoint: the forward keeps
    only the final state; the backward walks the layers in reverse,
    rebuilding each layer's input with the ``-step`` EES step and replaying
    the step under autograd for its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, block_fn, layers, step, y0, *flat):
        y = y0
        for lp in layers:
            y = _ees_step(block_fn, lp, y, step)
        if y is y0:  # no layer
            y = y0.clone()
        ctx.block_fn, ctx.layers, ctx.step = block_fn, layers, step
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, ct):
        (y,) = ctx.saved_tensors
        block_fn, step = ctx.block_fn, ctx.step
        grads = []
        for lp in reversed(ctx.layers):
            with torch.no_grad():
                y_prev = _ees_step(block_fn, lp, y, -step)  # the layer's input
            replay, leaves = _replay_layer(lp)
            wanted = [t for t in leaves if t.requires_grad]
            with torch.enable_grad():
                yp = y_prev.detach().requires_grad_()
                out = _ees_step(block_fn, replay, yp, step)
                got = torch.autograd.grad(out, [yp] + wanted, ct, allow_unused=True)
            ct = got[0]
            by_leaf = iter(got[1:])
            grads.append([next(by_leaf) if t.requires_grad else None for t in leaves])
            y = y_prev
        flat = [g for layer in reversed(grads) for g in layer]
        return (None, None, None, ct, *flat)


def ees_depth_solve(block_fn: Callable, layers: Sequence, y0, step: float = 1.0,
                    adjoint: str = "reversible"):
    """Integrate the depth-ODE with EES(2,5), one step per layer.

    ``adjoint="full"`` backpropagates through every stage (autograd keeps
    each layer's activations); ``"reversible"`` (default) stores no
    per-layer activation and rebuilds them in the backward."""
    if adjoint == "full":
        y = y0
        for lp in layers:
            y = _ees_step(block_fn, lp, y, step)
        return y
    if adjoint != "reversible":
        raise ValueError(adjoint)
    layers = list(layers)
    flat = [t for lp in layers for t in _leaves(lp)]
    return _ReversibleDepth.apply(block_fn, layers, float(step), y0, *flat)
