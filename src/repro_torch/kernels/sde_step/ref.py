"""Plain PyTorch twins of the fused SDE-step kernels (port of
``repro.kernels.sde_step.ref``).

The CPU path of :mod:`repro_torch.kernels.sde_step.ops` *is* these
functions, and each CUDA kernel repeats its twin's arithmetic operation by
operation.  The general-noise twins form ``g@dW`` as an explicit left-to-right
sum over the channels (``acc = g_0*dW_0; acc = acc + g_j*dW_j``), the order
their kernels sum in; the reference's twins use an einsum, so the two agree
to rounding, not bitwise.
"""
from __future__ import annotations


def increment_diag_ref(f, g, dW, h):
    """k = f*h + g*dW (diagonal noise: elementwise product)."""
    return f * h + g * dW


def increment_pre_ref(f, w, h):
    """k = f*h + w (prediffused additive noise: ``w`` is already ``g*dW``)."""
    return f * h + w


def gdw_ref(g, dW):
    """``g@dW`` per row, ``(..., d, m) x (..., m) -> (..., d)``, summed over
    the channels left to right."""
    acc = g[..., 0] * dW[..., None, 0]
    for j in range(1, g.shape[-1]):
        acc = acc + g[..., j] * dW[..., None, j]
    return acc


def increment_general_ref(f, g, dW, h):
    """k = f*h + g@dW (general noise: ``(..., d, m) x (..., m) -> (..., d)``)."""
    return f * h + gdw_ref(g, dW)


def ws_stage_diag_ref(delta, y, f, g, dW, h, a: float, b: float):
    """One fused Williamson 2N stage under diagonal noise.

    k = f*h + g*dW;  delta' = a*delta + k;  y' = y + b*delta'.
    """
    k = f * h + g * dW
    d2 = a * delta + k
    y2 = y + b * d2
    return d2, y2


def ws_stage_pre_ref(delta, y, f, w, h, a: float, b: float):
    """One fused Williamson 2N stage with a prediffused increment ``w = g*dW``:
    one operand stream fewer than the diagonal stage."""
    k = f * h + w
    d2 = a * delta + k
    y2 = y + b * d2
    return d2, y2


def ws_stage_general_ref(delta, y, f, g, dW, h, a: float, b: float):
    """One fused Williamson 2N stage under general noise:
    ``k = f*h + g@dW``, then the 2N update."""
    k = f * h + gdw_ref(g, dW)
    d2 = a * delta + k
    y2 = y + b * d2
    return d2, y2


def ws_stage_diag_bwd_ref(ct_d2, ct_y2, g, dW, h, a: float, b: float):
    """VJP of :func:`ws_stage_diag_ref` with respect to ``(delta, f, g, dW)``:
    ``common = ct_delta' + b*ct_y'``; returns
    ``(a*common, h*common, dW*common, g*common)``."""
    common = ct_d2 + b * ct_y2
    return a * common, h * common, dW * common, g * common


def axpy_chain_ref(y, incs, coeffs):
    """y + sum_i coeffs[i] * incs[i], accumulated left to right
    (``acc = y; acc = acc + c_i*inc_i``), the order of the reference's
    kernel body and of the plain ``tree_axpy`` chain.  ``incs`` is a
    sequence of tensors (the reference's twin takes them stacked and sums
    the products first; the two agree to rounding)."""
    acc = y
    for c, k in zip(coeffs, incs):
        acc = acc + c * k
    return acc
