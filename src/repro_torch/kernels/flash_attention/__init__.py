"""Flash attention kernel (Hopper CUDA) with its plain twin; layout as in
``repro.kernels.flash_attention``."""
from .ops import attention

__all__ = ["attention"]
