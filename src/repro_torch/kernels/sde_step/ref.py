"""Plain PyTorch twins of the fused SDE-step kernels (port of
``repro.kernels.sde_step.ref``, the diagonal-noise kernels and the axpy
chain).

The CPU path of :mod:`repro_torch.kernels.sde_step.ops` *is* these
functions, and each CUDA kernel repeats its twin's arithmetic operation by
operation.
"""
from __future__ import annotations


def increment_diag_ref(f, g, dW, h):
    """k = f*h + g*dW (diagonal noise: elementwise product)."""
    return f * h + g * dW


def ws_stage_diag_ref(delta, y, f, g, dW, h, a: float, b: float):
    """One fused Williamson 2N stage under diagonal noise.

    k = f*h + g*dW;  delta' = a*delta + k;  y' = y + b*delta'.
    """
    k = f * h + g * dW
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
