"""Attention paths for the LM substrate (port of ``repro.models.attention``).

Two interchangeable implementations of causal/bidirectional GQA attention:

* ``flash`` — the hand-written CUDA kernel
  (:mod:`repro_torch.kernels.flash_attention`), on CUDA tensors;
* ``chunked`` — online softmax over query chunks in plain torch: O(S * chunk)
  live memory instead of O(S^2); the path off the card and for
  ``use_flash="never"``.

Both accept q (B, H, Sq, hd), k/v (B, KV, Sk, hd) and broadcast KV heads by
GQA grouping.  :func:`decode_attention` is the one-token path against a
cache (plain torch; it reaches no kernel, as in the reference).

Under a mesh (DTensor inputs) both run on each rank's local shard
(:func:`repro_torch.spmd.gqa_map`): the batch as q shards it, and the
query heads where the mesh axis divides them, the KV heads beside them
where it divides those too, else each rank's KV head of its query group
taken from K and V whole.  ``flash`` takes the DTensors to the kernel's
dispatch, which maps them to the shards itself, and ``chunked`` and
:func:`decode_attention` are mapped here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention.ops import attention as flash_dispatch
from ..spmd import gqa_map, mesh_of

__all__ = ["gqa_attention", "decode_attention"]


def _chunked(q, k, v, *, causal: bool, sm_scale: float, chunk: int):
    b, hq, sq, d = q.shape
    _, hk, sk, _ = k.shape
    group = hq // hk
    kr = torch.repeat_interleave(k, group, dim=1).float()
    vr = torch.repeat_interleave(v, group, dim=1).float()
    chunk = min(chunk, sq)
    if sq % chunk:
        chunk = math.gcd(sq, chunk) or sq
    nq = sq // chunk
    cols = torch.arange(sk, device=q.device)
    outs = []
    for idx in range(nq):
        qc = q[:, :, idx * chunk:(idx + 1) * chunk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kr) * sm_scale
        if causal:
            rows = idx * chunk + torch.arange(chunk, device=q.device)
            s = torch.where(rows[:, None] >= cols[None, :], s, -1e30)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vr))
    return torch.cat(outs, dim=2).to(q.dtype)


def gqa_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    use_flash: str = "auto",
    chunk: int = 512,
):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if use_flash in ("auto", "interpret"):
        if use_flash == "interpret" or q.device.type == "cuda":
            return flash_dispatch(
                q, k, v, causal=causal, sm_scale=sm_scale, use_kernel=use_flash
            )
    mesh = mesh_of(q, k, v)
    if mesh is not None:
        return gqa_map(lambda *t: _chunked(*t, causal=causal, sm_scale=sm_scale, chunk=chunk),
                       mesh, q, k, v)
    return _chunked(q, k, v, causal=causal, sm_scale=sm_scale, chunk=chunk)


def decode_attention(q, k_cache, v_cache, pos, *, sm_scale: Optional[float] = None):
    """Single-token attention against a (B, KV, S_max, hd) cache.

    ``pos`` (an int or a 0-d integer tensor) is the index of the *current*
    token (attend to cols <= pos).  O(S_max) per token.  Under a mesh each
    rank attends over its batch shard of the cache, as ``q`` is laid out
    (``attn_block_decode`` lays it out as the cache's batch).
    """
    mesh = mesh_of(q, k_cache, v_cache)
    if mesh is not None:
        return gqa_map(lambda *t: _decode(*t, pos, sm_scale), mesh, q, k_cache, v_cache)
    return _decode(q, k_cache, v_cache, pos, sm_scale)


def _decode(q, k_cache, v_cache, pos, sm_scale):
    b, hq, one, d = q.shape
    _, hk, smax, _ = k_cache.shape
    group = hq // hk
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kr = torch.repeat_interleave(k_cache, group, dim=1).float()
    vr = torch.repeat_interleave(v_cache, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * sm_scale  # (B, H, 1, S)
    cols = torch.arange(smax, device=q.device)
    s = torch.where(cols <= pos, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return out.to(q.dtype)
