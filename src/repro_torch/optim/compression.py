"""Gradient compression: int8 quantisation with error feedback (port of
``repro.optim.compression``).

Gradients are quantised to int8 with one float32 scale a tensor before
they cross the wire (4x fewer bytes than float32), and the quantisation
residual is carried into the next step (error feedback), which leaves
SGD/Adam convergence unaffected to first order (Karimireddy et al., 2019).

:func:`compressed_psum_with_feedback` is the collective: each rank passes
its block of a stacked leading axis, the int8 payloads and the scales are
all-gathered over the mesh axis (the int8 payload is what crosses the
wire), and every rank dequantises them and sums them in rank order, so the
sum is the same on every rank and does not depend on the collective's
algorithm.
"""
from __future__ import annotations

import torch

from ..core.pytree import tree_flatten, tree_unflatten
from ..launch.mesh import axis_block, gather_blocks

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_with_feedback",
           "compress_grads_tree"]


def quantize_int8(x: torch.Tensor):
    """``(q, scale)``: ``scale = max|x| / 127 + 1e-12`` (a 0-dim tensor of
    x's dtype), ``q = clip(round(x / scale), -127, 127)`` as int8, rounding
    half to even."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in float32, or in scale's dtype where that is wider."""
    return q.to(torch.promote_types(torch.float32, scale.dtype)) * scale


def compressed_psum_with_feedback(mesh, axis: str, x_block, err_block):
    """Sum ``x_block`` over the ranks of ``mesh``'s axis ``axis`` through
    int8, with error feedback.

    Each rank passes its block of the stacked leading axis and its residual
    from the last round; ``val = x_block + err_block`` is quantised, the int8
    payloads and float32 scales are all-gathered, and every rank returns the
    dequantised blocks summed in rank order (the same tensor on every rank)
    and its new residual ``val - dequantize(quantize(val))``."""
    val = x_block + err_block
    q, scale = quantize_int8(val)
    new_err = val - dequantize_int8(q, scale)
    block = axis_block(mesh, axis)
    qs = gather_blocks(q[None], block)
    scales = gather_blocks(scale.reshape(1), block)
    out = dequantize_int8(qs[0], scales[0])
    for r in range(1, block.world):
        out = out + dequantize_int8(qs[r], scales[r])
    return out, new_err


def compress_grads_tree(grads, err_tree, mesh=None, axis: str = "data"):
    """Leaf by leaf int8 quantise-with-feedback of a gradient tree: returns
    ``(dequantised gradients in their dtypes, new float32 residuals)``.
    ``mesh``/``axis`` are the reference's (its sum is implicit under SPMD);
    the sum across ranks is :func:`compressed_psum_with_feedback`."""
    del mesh, axis
    g_leaves, treedef = tree_flatten(grads)
    e_leaves = tree_flatten(err_tree)[0]
    out_g, out_e = [], []
    for g, e in zip(g_leaves, e_leaves):
        val = g.to(torch.float32) + e
        q, scale = quantize_int8(val)
        deq = dequantize_int8(q, scale)
        out_g.append(deq.to(g.dtype))
        out_e.append(val - deq)
    return tree_unflatten(treedef, out_g), tree_unflatten(treedef, out_e)
