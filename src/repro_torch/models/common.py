"""Shared model plumbing: options, sharding policy, dtype helpers (port of
``repro.models.common``).

The port runs on one device, so the sharding hooks are the identity: a
:class:`ShardingPolicy` naming mesh axes, decode-cache constraints, or a
:func:`constrain` spec raise :class:`~repro_torch.device.NotYetPorted`
(multi-device layouts come with ROADMAP A14d: DTensor tensor parallelism).  ``remat`` rematerialises
each layer in the backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` of its scanned layer; it changes nothing on a pass
without gradients.  ``bf16_ar_barrier`` pins nothing on one device.
``attn_impl="stub"`` (the reference's dry-run cost isolation) raises
``NotYetPorted``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import not_yet_ported

__all__ = ["ModelOptions", "ShardingPolicy", "NO_SHARDING", "dtype_of", "constrain"]


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
                                 "activation sharding; ROADMAP A14d)")

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
    remat: bool = False  # recompute each layer in the backward
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
                                 "layout pins on a mesh; ROADMAP A14d)")

    def constrain_cache(self, name: str, x):
        return x


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def constrain(x, spec=None):
    """The reference's sharding constraint: ``spec=None`` returns ``x``; a
    spec (a mesh layout) raises ``NotYetPorted`` (ROADMAP A14d)."""
    if spec is not None:
        raise not_yet_ported("constrain with a sharding spec (multi-device "
                             "activation sharding; ROADMAP A14d)")
    return x
