"""Plain PyTorch twin of the fused SDE-step kernel (port of
``repro.kernels.sde_step.ref``, the diagonal stage).

The CPU path of :mod:`repro_torch.kernels.sde_step.ops` *is* this function,
and the CUDA kernel repeats its arithmetic operation by operation.
"""
from __future__ import annotations


def ws_stage_diag_ref(delta, y, f, g, dW, h, a: float, b: float):
    """One fused Williamson 2N stage under diagonal noise.

    k = f*h + g*dW;  delta' = a*delta + k;  y' = y + b*delta'.
    """
    k = f * h + g * dW
    d2 = a * delta + k
    y2 = y + b * d2
    return d2, y2
