"""Architecture & shape registry (port of ``repro.configs``): one module per
assigned arch, all ten registered when this package is imported."""
from . import (  # noqa: F401
    hubert_xlarge,
    mamba2_130m,
    olmo_1b,
    olmoe_1b_7b,
    qwen1p5_32b,
    qwen2_vl_2b,
    qwen3_1p7b,
    qwen3_moe_30b_a3b,
    yi_9b,
    zamba2_7b,
)
from .base import ArchConfig, get_arch, list_archs, register
from .shapes import ALL_SHAPES, ShapeSpec, cell_applicable, get_shape

__all__ = [
    "ArchConfig",
    "get_arch",
    "list_archs",
    "register",
    "ALL_SHAPES",
    "ShapeSpec",
    "cell_applicable",
    "get_shape",
]
