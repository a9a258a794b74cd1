"""Shared model plumbing: options, sharding policy, dtype helpers (port of
``repro.models.common``).

The port runs on one device, so the sharding hooks are the identity: a
:class:`ShardingPolicy` naming mesh axes, or decode-cache constraints, raise
:class:`~repro_torch.device.NotYetPorted` (multi-device layouts come with
ROADMAP A14).  ``remat`` is accepted and changes nothing on an inference
pass; ``bf16_ar_barrier`` pins nothing on one device.  ``attn_impl="stub"``
(the reference's dry-run cost isolation) raises ``NotYetPorted``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import not_yet_ported

__all__ = ["ModelOptions", "ShardingPolicy", "NO_SHARDING", "dtype_of"]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Activation sharding constraints; only the default (no axes) is
    ported, and every hook then returns its input unchanged."""

    batch_axes: Optional[tuple] = None
    model_axis: Optional[str] = None
    seq_axes: Optional[tuple] = None

    def __post_init__(self):
        if (self.batch_axes, self.model_axis, self.seq_axes) != (None, None, None):
            raise not_yet_ported("ShardingPolicy with mesh axes (multi-device "
                                 "activation sharding)")

    def hidden(self, h):
        return h

    def ffn(self, h):
        return h

    def heads(self, x):
        return x

    def moe_dispatch(self, x):
        return x


NO_SHARDING = ShardingPolicy()


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    remat: bool = False  # no effect on an inference pass
    use_flash: str = "auto"  # kernel dispatch: auto | never | interpret
    attn_chunk: int = 512  # q-chunk of the plain (non-flash) attention path
    shard: ShardingPolicy = NO_SHARDING
    logits_f32: bool = True  # cast the logits to float32 at the head
    ssd_chunk: int = 128
    cache_constraints: Optional[dict] = None
    # "real" only: the reference's "stub" (the dry run's cost isolation)
    # comes with the dry run (ROADMAP A16)
    attn_impl: str = "real"
    bf16_ar_barrier: bool = False  # identity on one device

    def __post_init__(self):
        if self.attn_impl != "real":
            raise not_yet_ported(f"ModelOptions.attn_impl={self.attn_impl!r} (the "
                                 "dry run's cost isolation)")
        if self.cache_constraints is not None:
            raise not_yet_ported("ModelOptions.cache_constraints (decode-cache "
                                 "layout pins on a mesh)")

    def constrain_cache(self, name: str, x):
        return x


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
