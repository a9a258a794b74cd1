"""Hand-written Hopper kernels of the port, each beside its plain torch twin.

``KERNELS`` lists every CUDA kernel the package builds (one nvcc build per
source, on first use); :func:`build_kernels` builds them all in parallel.
"""
from ._build import build_all
from .sde_step.sde_step import KERNEL as WS_STAGE_DIAG
from .williamson2n.williamson2n import KERNEL as WILLIAMSON2N

KERNELS = (WS_STAGE_DIAG, WILLIAMSON2N)

__all__ = ["KERNELS", "WS_STAGE_DIAG", "WILLIAMSON2N", "build_kernels"]


def build_kernels() -> float:
    """Build every kernel library; returns the wall seconds spent."""
    return build_all(KERNELS)
