"""Hand-written Hopper kernels of the port, each beside its plain torch twin.

``KERNELS`` lists every CUDA kernel the package builds (one nvcc build per
source, on first use); :func:`build_kernels` builds them all in parallel.
"""
from ._build import build_all
from .sde_step.sde_step import AXPY_CHAIN, INCREMENT_DIAG, WS_STAGE_DIAG, WS_STAGE_DIAG_BWD
from .williamson2n.williamson2n import KERNEL as WILLIAMSON2N

KERNELS = (WS_STAGE_DIAG, WILLIAMSON2N, WS_STAGE_DIAG_BWD, INCREMENT_DIAG,
           AXPY_CHAIN)

__all__ = ["KERNELS", "WS_STAGE_DIAG", "WILLIAMSON2N", "WS_STAGE_DIAG_BWD",
           "INCREMENT_DIAG", "AXPY_CHAIN", "build_kernels"]


def build_kernels() -> float:
    """Build every kernel library; returns the wall seconds spent."""
    return build_all(KERNELS)
