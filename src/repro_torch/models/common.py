"""Shared model plumbing: options, sharding policy, dtype helpers (port of
``repro.models.common``).

A :class:`ShardingPolicy` naming mesh axes lays activations out on the
ambient mesh (``with mesh:``, :func:`repro_torch.launch.mesh.ambient_mesh`)
exactly where the reference's ``with_sharding_constraint`` does: each hook
takes the reference's ``PartitionSpec`` for its layout and redistributes
the activation, a DTensor, to those placements (a plain tensor is the
replicated value every rank holds).  With no axes every hook, like
:func:`constrain` with ``spec=None`` and :meth:`ModelOptions.constrain_cache`
without ``cache_constraints``, returns its input unchanged.  ``remat``
rematerialises each layer in the backward (``torch.utils.checkpoint``), as
the reference's ``jax.checkpoint`` of its scanned layer; it changes nothing
on a pass without gradients.  ``bf16_ar_barrier`` pins nothing: eager torch
runs ops in program order, so there is no upcast for a compiler to hoist
above the all-reduce.  ``attn_impl="stub"`` is the reference's dry-run cost
isolation: attention hands its queries through as its output and the Mamba
block's scan is ``x * dt``, so a traced layer moves what the fused kernels
leave in HBM and no more (``repro_torch.launch.dryrun``).  Any value other
than ``"real"`` and ``"stub"`` raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..spmd import mesh_of, placements_for, redistribute

__all__ = ["ModelOptions", "ShardingPolicy", "NO_SHARDING", "dtype_of", "constrain"]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Activation sharding constraints (None = leave the layout as it comes).

    ``batch_axes`` shards the batch dim of activations; ``model_axis`` shards
    heads / ffn-hidden / experts; ``seq_axes`` (optional) shards the sequence
    dim instead of batch for long-context small-batch cells (SP).  A spec
    entry whose axes do not divide its dim is left replicated.
    """

    batch_axes: Optional[tuple] = None  # e.g. ("pod", "data")
    model_axis: Optional[str] = None  # e.g. "model"
    seq_axes: Optional[tuple] = None  # e.g. ("data",) for long-context

    def hidden(self, h):
        """(B, S, D) activation constraint."""
        if self.batch_axes is None and self.seq_axes is None:
            return h
        return constrain(h, (self.batch_axes, self.seq_axes, None))

    def ffn(self, h):
        """(B, S, F) hidden constraint: model-shard the wide dim."""
        if self.batch_axes is None and self.model_axis is None:
            return h
        return constrain(h, (self.batch_axes, self.seq_axes, self.model_axis))

    def heads(self, x):
        """(B, H, S, hd) attention layout constraint."""
        if self.batch_axes is None and self.model_axis is None:
            return x
        return constrain(x, (self.batch_axes, self.model_axis, self.seq_axes, None))

    def moe_dispatch(self, x):
        """Expert-parallel layout of the port's expert-major dispatch
        ``(E, groups * cap, d)``: experts on the model axis, the groups on
        the batch axes (the reference's ``P(batch, model, None, None)`` on
        its ``(groups, E, cap, d)``)."""
        if self.batch_axes is None and self.model_axis is None:
            return x
        return constrain(x, (self.model_axis, self.batch_axes, None))


NO_SHARDING = ShardingPolicy()


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    remat: bool = False  # recompute each layer in the backward
    use_flash: str = "auto"  # kernel dispatch: auto | never | interpret
    attn_chunk: int = 512  # q-chunk of the plain (non-flash) attention path
    shard: ShardingPolicy = NO_SHARDING
    logits_f32: bool = True  # cast the logits to float32 at the head
    ssd_chunk: int = 128
    # Decode-cache layout pins: name -> spec of the *per-layer* cache leaf
    # (leading layer axis stripped), as the reference's
    cache_constraints: Optional[dict] = None
    attn_impl: str = "real"  # real | stub (the dry run's cost isolation)
    bf16_ar_barrier: bool = False  # nothing to pin in eager torch

    def __post_init__(self):
        if self.attn_impl not in ("real", "stub"):
            raise ValueError(f"ModelOptions.attn_impl={self.attn_impl!r}: 'real' or 'stub'")

    def constrain_cache(self, name: str, x):
        if self.cache_constraints is None or name not in self.cache_constraints:
            return x
        return constrain(x, self.cache_constraints[name])


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def constrain(x, spec=None):
    """The reference's sharding constraint: ``spec=None`` returns ``x``;
    otherwise ``x`` laid out as ``spec`` on its mesh (a DTensor's) or the
    ambient one (a plain tensor: the replicated value)."""
    if spec is None:
        return x
    mesh = mesh_of(x)
    if mesh is None:
        from ..launch.mesh import ambient_mesh

        mesh = ambient_mesh()
    return redistribute(x, placements_for(mesh, spec, x.shape), mesh)
