"""The four assigned input-shape cells for every LM architecture.

``train_*`` lowers ``train_step``; ``decode_*`` / ``long_*`` lower
``serve_step`` (one new token against a KV/state cache of ``seq_len``).
``long_500k`` requires sub-quadratic sequence mixing and is only run for
SSM/hybrid archs; encoder-only archs have no decode at all (see
DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def get_shape(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only: no autoregressive decode"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "needs sub-quadratic sequence mixing (SSM/hybrid only)"
    return True, ""
