"""Plain PyTorch twin of the Williamson 2N update kernel (port of
``repro.kernels.williamson2n.ref``)."""
from __future__ import annotations


def williamson2n_ref(delta, k, y, a: float, b: float):
    d2 = a * delta + k
    y2 = y + b * d2
    return d2, y2
