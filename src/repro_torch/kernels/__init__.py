"""Hand-written Hopper kernels of the port, each beside its plain torch twin.

``KERNELS`` lists every CUDA kernel the package builds (one nvcc build per
source, on first use); :func:`build_kernels` builds them all in parallel.
"""
from ._build import build_all
from .flash_attention.flash_attention import KERNEL as FLASH_ATTENTION
from .flash_attention.flash_attention import KERNEL_BWD as FLASH_ATTENTION_BWD
from .sde_step.sde_step import (AXPY_CHAIN, INCREMENT_DIAG, INCREMENT_GENERAL, INCREMENT_PRE,
                                WS_STAGE_DIAG, WS_STAGE_DIAG_BWD, WS_STAGE_GENERAL,
                                WS_STAGE_PRE)
from .ssd_scan.ssd_scan import KERNEL as SSD_SCAN
from .ssd_scan.ssd_scan import KERNEL_BWD as SSD_SCAN_BWD
from .williamson2n.williamson2n import KERNEL as WILLIAMSON2N

KERNELS = (WS_STAGE_DIAG, WILLIAMSON2N, WS_STAGE_DIAG_BWD, INCREMENT_DIAG,
           AXPY_CHAIN, INCREMENT_PRE, WS_STAGE_PRE, INCREMENT_GENERAL,
           WS_STAGE_GENERAL, FLASH_ATTENTION, SSD_SCAN, FLASH_ATTENTION_BWD,
           SSD_SCAN_BWD)

__all__ = ["KERNELS", "WS_STAGE_DIAG", "WILLIAMSON2N", "WS_STAGE_DIAG_BWD",
           "INCREMENT_DIAG", "AXPY_CHAIN", "INCREMENT_PRE", "WS_STAGE_PRE",
           "INCREMENT_GENERAL", "WS_STAGE_GENERAL", "FLASH_ATTENTION",
           "SSD_SCAN", "FLASH_ATTENTION_BWD", "SSD_SCAN_BWD", "build_kernels"]


def build_kernels() -> float:
    """Build every kernel library; returns the wall seconds spent."""
    return build_all(KERNELS)
