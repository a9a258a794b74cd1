"""Williamson 2N update kernel (Hopper CUDA); layout as in
``repro.kernels.williamson2n``."""
from .ops import williamson2n_update

__all__ = ["williamson2n_update"]
