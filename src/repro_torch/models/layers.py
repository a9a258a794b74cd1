"""Transformer building blocks: norms, RoPE, GQA attention block, MLPs (port
of ``repro.models.layers``).

Parameters are ``nn.ParameterDict``s under the reference's key names; every
block is a function ``f(params, x, ...)`` on tensors.  Weight layouts are the
reference's (``x @ w`` with ``w`` as ``(d_in, d_out)``).

Under a mesh the weights are DTensors placed by the reference's rules
(``repro_torch.launch.mesh.param_pspecs``): the column products
(``wq``/``wk``/``wv``/``wg``/``wu``) come out sharded on their last dim,
which the head split keeps on the heads, and the row products
(``wo``/``wd``) come out as partial sums that the caller's ``hidden``
constraint reduces.  The sharding hooks sit where the reference's do.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng
from ..spmd import (batch_like, block_of, is_dtensor, like, merge_last, redistribute,
                    replicated_partials, split_last)
from .attention import decode_attention, gqa_attention
from .common import ModelOptions

__all__ = [
    "rmsnorm",
    "nonparam_layernorm",
    "apply_norm",
    "rope",
    "init_attn_block",
    "attn_block",
    "attn_block_decode",
    "init_mlp",
    "mlp_block",
]


def param_dict(leaves) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in leaves.items()})


def scaled_normal(key, shape, scale: float, dtype, *, divide: bool = False):
    """``(normal(key, shape) * scale).astype(dtype)`` as the reference draws
    its weights (float32 normals, scaled, then cast); ``divide`` divides by
    ``scale`` instead, where the reference does."""
    z = prng.normal(key, shape, torch.float32)
    return (z / scale if divide else z * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms (computed in float32, cast back).
# ---------------------------------------------------------------------------

def rmsnorm(scale, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if is_dtensor(var):  # a mean over a sharded dim: reduced here, replicated
        var = replicated_partials(var)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def nonparam_layernorm(x, eps: float = 1e-5):
    """OLMo-style non-parametric LayerNorm: no scale, no bias."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, scale, x):
    if kind == "rmsnorm":
        return rmsnorm(scale, x)
    if kind == "nonparam_ln":
        return nonparam_layernorm(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE.
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float = 10000.0):
    """x: (..., S, hd) with hd even; positions: (S,) or (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs  # (..., S, half)
    cos, sin = like(torch.cos(ang), x), like(torch.sin(ang), x)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention block.
# ---------------------------------------------------------------------------

def init_attn_block(cfg, key, dtype) -> nn.ParameterDict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    ks = prng.split(key, 5)
    sd = 1.0 / math.sqrt(d)
    dev = key.device
    p = {
        "wq": scaled_normal(ks[0], (d, cfg.n_heads * hd), sd, dtype),
        "wk": scaled_normal(ks[1], (d, cfg.n_kv_heads * hd), sd, dtype),
        "wv": scaled_normal(ks[2], (d, cfg.n_kv_heads * hd), sd, dtype),
        "wo": scaled_normal(ks[3], (cfg.n_heads * hd, d), sd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.n_heads * hd, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(cfg.n_kv_heads * hd, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(cfg.n_kv_heads * hd, dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=dev)
    if cfg.norm == "rmsnorm":
        p["ln"] = torch.ones(d, dtype=dtype, device=dev)
    return param_dict(p)


def _qkv(cfg, p, x, positions):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_last(q, cfg.n_heads).transpose(1, 2)
    k = split_last(k, cfg.n_kv_heads).transpose(1, 2)
    v = split_last(v, cfg.n_kv_heads).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_block(cfg, p, x, opts: ModelOptions):
    """Pre-norm attention sub-block (residual added by caller)."""
    b, s, d = x.shape
    h = apply_norm(cfg.norm, p.get("ln"), x)
    positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(cfg, p, h, positions)
    q = opts.shard.heads(q)
    k = opts.shard.heads(k)
    v = opts.shard.heads(v)
    if opts.attn_impl == "stub":
        o = q  # dry-run cost isolation: no mixing compute / score traffic
    else:
        o = gqa_attention(
            q, k, v, causal=cfg.causal, use_flash=opts.use_flash, chunk=opts.attn_chunk
        )
    o = merge_last(o.transpose(1, 2))
    return o @ p["wo"]


def position_index(pos, device) -> torch.Tensor:
    """``pos`` (an int or a 0-d integer tensor) as a (1,) int64 tensor on
    ``device``, filled there (no host-to-device copy)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), int(pos), dtype=torch.int64, device=device)


def _write_slot(cache, row, slot):
    """``cache[:, :, slot] = row`` in place, ``cache`` (B, KV, S, hd).  A
    DTensor cache takes the row in its own layout on its local tensor; where
    the sequence is sharded, the rank holding ``slot`` writes it and the
    others rewrite a row of their own unchanged (no host read of ``slot``)."""
    row = row.to(cache.dtype)
    if not is_dtensor(cache):
        cache.index_copy_(2, slot, row)
        return
    from torch.distributed.tensor import Replicate

    mesh, pl = cache.device_mesh, cache.placements
    row = redistribute(row, tuple(Replicate() if p.is_shard() and p.dim == 2 else p
                                  for p in pl), mesh)
    start, size = block_of(cache, 2)
    with torch.no_grad():  # the local tensor itself (a decode write is not differentiated)
        row, local = row.to_local(), cache.to_local()
        if size != cache.shape[2]:
            rel = slot - start
            mine = ((rel >= 0) & (rel < size)).reshape(())
            slot = rel.clamp(0, size - 1)
            row = torch.where(mine, row, local.index_select(2, slot))
        local.index_copy_(2, slot, row)


def attn_block_decode(cfg, p, x, k_cache, v_cache, pos):
    """One-token attention against a cache; returns (out, k_cache, v_cache).

    The caches are updated in place (the reference returns new arrays):
    k and v land at index ``pos``, clamped into the cache as
    ``dynamic_update_slice`` clamps it, in the caches' own layout.  Under a
    mesh q, k and v are first laid out on the cache's batch shard (under
    FSDP ``x @ wq`` comes back as partial sums over ``"data"``, which would
    otherwise gather the whole cache), so each rank attends over its own
    rows of the cache.
    """
    b, one, d = x.shape
    hd = cfg.resolved_head_dim
    h = apply_norm(cfg.norm, p.get("ln"), x)
    idx = position_index(pos, x.device)
    q, k, v = (batch_like(t, k_cache) for t in _qkv(cfg, p, h, idx))
    # q, k, v: (B, H/KV, 1, hd); insert k, v at position pos.
    slot = idx.clamp(0, k_cache.shape[2] - 1)
    _write_slot(k_cache, k, slot)
    _write_slot(v_cache, v, slot)
    o = decode_attention(q, k_cache, v_cache, pos)
    o = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * hd)
    return o @ p["wo"], k_cache, v_cache


# ---------------------------------------------------------------------------
# MLPs.
# ---------------------------------------------------------------------------

def init_mlp(cfg, key, dtype, d_ff: Optional[int] = None) -> nn.ParameterDict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    ks = prng.split(key, 3)
    sd_in, sd_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    if cfg.mlp == "swiglu":
        p = {
            "wg": scaled_normal(ks[0], (d, f), sd_in, dtype),
            "wu": scaled_normal(ks[1], (d, f), sd_in, dtype),
            "wd": scaled_normal(ks[2], (f, d), sd_out, dtype),
        }
    else:  # gelu
        p = {
            "wu": scaled_normal(ks[1], (d, f), sd_in, dtype),
            "wd": scaled_normal(ks[2], (f, d), sd_out, dtype),
        }
    if cfg.norm == "rmsnorm":
        p["ln"] = torch.ones(d, dtype=dtype, device=key.device)
    return param_dict(p)


def mlp_block(cfg, p, x, opts: ModelOptions):
    h = apply_norm(cfg.norm, p.get("ln"), x)
    if cfg.mlp == "swiglu":
        inner = F.silu(h @ p["wg"]) * (h @ p["wu"])
    else:
        inner = F.gelu(h @ p["wu"], approximate="tanh")  # jax.nn.gelu's default
    inner = opts.shard.ffn(inner)
    return inner @ p["wd"]
