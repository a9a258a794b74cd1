"""Chunked Mamba2 SSD scan kernel (Hopper CUDA) with its plain twins; layout
as in ``repro.kernels.ssd_scan``."""
from .ops import ssd

__all__ = ["ssd"]
