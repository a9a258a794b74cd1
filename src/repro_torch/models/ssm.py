"""Mamba2 (SSD) block: chunked-scan prefill path + O(1)-state decode path
(port of ``repro.models.ssm``).

Structure follows the reference: in_proj split into per-stream projections
(z | x | B | C | dt), causal depthwise conv over (x | B | C), SSD scan with
per-head scalar decay, gated RMSNorm, out_proj; a single SSM group (B/C
shared across heads).  The full-sequence path calls
:func:`repro_torch.kernels.ssd_scan.ops.ssd` (the CUDA kernel on the card,
the chunked twin elsewhere).  Decode carries (conv windows, SSD state):
state size independent of context length.

Under a mesh the projections follow the reference's rules: ``wz``, ``wx``,
``wB``, ``wC``, ``wdt`` and the convs column-sharded, ``out_proj``
row-sharded, the per-head and per-channel vectors sharded with them.  The
depthwise conv and the decode recurrence run on each rank's channels and
heads (:func:`repro_torch.spmd.local_map`), the scan through its wrapper's
own local dispatch; the gated RMSNorm over the sharded ``d_inner`` is a
cross-rank mean.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng
from ..kernels.ssd_scan.ops import ssd
from ..spmd import heads_layout, local_map, merge_last, mesh_of, moved
from .common import ModelOptions
from .layers import param_dict, rmsnorm, scaled_normal, split_last

__all__ = ["init_mamba_block", "mamba_block", "mamba_block_decode", "init_mamba_cache"]


def _dims(cfg):
    return cfg.d_inner, cfg.ssm_state, cfg.ssm_heads


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear cut-over)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba_block(cfg, key, dtype) -> nn.ParameterDict:
    d = cfg.d_model
    di, ds, nh = _dims(cfg)
    ks = prng.split(key, 9)
    sd = 1.0 / math.sqrt(d)
    K = cfg.ssm_conv
    dev = key.device

    def zeros(n, dt=dtype):
        return torch.zeros(n, dtype=dt, device=dev)

    return param_dict({
        "ln": torch.ones(d, dtype=dtype, device=dev),
        "wz": scaled_normal(ks[0], (d, di), sd, dtype),
        "wx": scaled_normal(ks[1], (d, di), sd, dtype),
        "wB": scaled_normal(ks[2], (d, ds), sd, dtype),
        "wC": scaled_normal(ks[3], (d, ds), sd, dtype),
        "wdt": scaled_normal(ks[4], (d, nh), sd, dtype),
        "conv_x": scaled_normal(ks[5], (K, di), 0.1, dtype),
        "conv_B": scaled_normal(ks[6], (K, ds), 0.1, dtype),
        "conv_C": scaled_normal(ks[7], (K, ds), 0.1, dtype),
        "conv_bx": zeros(di),
        "conv_bB": zeros(ds),
        "conv_bC": zeros(ds),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev)),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "dt_bias": zeros(nh, torch.float32),
        "gate_norm": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": scaled_normal(ks[8], (di, d), math.sqrt(di), dtype, divide=True),
    })


def _causal_conv(x, w, b):
    """Depthwise causal conv along seq: x (B, S, C), w (K, C).  Under a
    mesh each rank convolves its own channels (and batch rows)."""
    mesh = mesh_of(x, w, b)
    if mesh is not None:
        px = heads_layout(mesh, x, 2)
        return local_map(_causal_conv, mesh, (x, w, b),
                         (px, moved(px, {2: 1}), moved(px, {2: 0})), px)
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def mamba_block(cfg, p, xin, opts: ModelOptions):
    """Prefill / full-sequence path via the chunked SSD."""
    bsz, s, d = xin.shape
    di, ds, nh = _dims(cfg)
    h = rmsnorm(p["ln"], xin)
    z = h @ p["wz"]
    x = h @ p["wx"]
    B = h @ p["wB"]
    C = h @ p["wC"]
    dt = h @ p["wdt"]
    x = F.silu(_causal_conv(x, p["conv_x"], p["conv_bx"]))
    B = F.silu(_causal_conv(B, p["conv_B"], p["conv_bB"]))
    C = F.silu(_causal_conv(C, p["conv_C"], p["conv_bC"]))
    dt = softplus(dt.float() + p["dt_bias"])  # (B,S,nh)
    A = -torch.exp(p["A_log"])  # (nh,)
    xh = split_last(x, nh)
    if opts.attn_impl == "stub":
        y = xh.float() * dt[..., None]  # cost isolation (dry run)
    else:
        y = ssd(
            xh.float(),
            dt,
            A,
            B.float(),
            C.float(),
            chunk=opts.ssd_chunk,
            use_kernel=opts.use_flash,  # same dispatch policy as attention
        )
    y = y + p["D"][None, None, :, None] * xh.float()
    y = merge_last(y).to(xin.dtype)
    y = rmsnorm(p["gate_norm"], y * F.silu(z))
    return y @ p["out_proj"]


def init_mamba_cache(cfg, batch, dtype, device):
    di, ds, nh = _dims(cfg)
    K = cfg.ssm_conv
    return {
        "conv_x": torch.zeros(batch, K - 1, di, dtype=dtype, device=device),
        "conv_B": torch.zeros(batch, K - 1, ds, dtype=dtype, device=device),
        "conv_C": torch.zeros(batch, K - 1, ds, dtype=dtype, device=device),
        "state": torch.zeros(batch, nh, cfg.ssm_head_dim, ds, dtype=torch.float32,
                             device=device),
    }


def _conv_step(cache, new, w, b):
    """One conv tick: cache (B, K-1, C), new (B, C); on each rank's own
    channels under a mesh."""
    mesh = mesh_of(cache, new, w, b)
    if mesh is not None:
        pn = heads_layout(mesh, new, 1)
        pc = moved(pn, {0: 0, 1: 2})
        return local_map(_conv_step, mesh, (cache, new, w, b),
                         (pc, pn, moved(pn, {1: 1}), moved(pn, {1: 0})), [pn, pc])
    window = torch.cat([cache, new[:, None]], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return out, window[:, 1:]


def _ssm_step(xh, dt, A, B, C, D, state):
    """The SSD recurrence for one token: xh (B, nh, dh), dt (B, nh) float32,
    A and D (nh,), B and C (B, ds), state (B, nh, dh, ds); returns (y, new
    state).  Under a mesh each rank steps its own heads (B and C whole)."""
    mesh = mesh_of(xh, dt, A, B, C, D, state)
    if mesh is not None:
        px = heads_layout(mesh, xh, 1)
        ph, pb = moved(px, {1: 0}), moved(px, {0: 0})
        return local_map(_ssm_step, mesh, (xh, dt, A, B, C, D, state),
                         (px, px, ph, pb, pb, ph, px), [px, px])
    a = torch.exp(A[None] * dt)  # (B, nh)
    xh = xh.float()
    dx = dt[..., None] * xh  # (B, nh, dh)
    S = a[..., None, None] * state + dx[..., None] * B.float()[:, None, None, :]
    y = torch.einsum("bhds,bs->bhd", S, C.float())
    return y + D[None, :, None] * xh, S


def mamba_block_decode(cfg, p, xin, cache):
    """One-token step: O(1) state update; returns (out, new cache)."""
    bsz, one, d = xin.shape
    di, ds, nh = _dims(cfg)
    h = rmsnorm(p["ln"], xin)[:, 0]  # (B, d)
    z = h @ p["wz"]
    x = h @ p["wx"]
    B = h @ p["wB"]
    C = h @ p["wC"]
    dt = h @ p["wdt"]
    x, conv_x = _conv_step(cache["conv_x"], x, p["conv_x"], p["conv_bx"])
    B, conv_B = _conv_step(cache["conv_B"], B, p["conv_B"], p["conv_bB"])
    C, conv_C = _conv_step(cache["conv_C"], C, p["conv_C"], p["conv_bC"])
    x, B, C = F.silu(x), F.silu(B), F.silu(C)
    dt = softplus(dt.float() + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"])
    y, S = _ssm_step(split_last(x, nh), dt, A, B, C, p["D"], cache["state"])
    y = y.reshape(bsz, di).to(xin.dtype)
    y = rmsnorm(p["gate_norm"], y * F.silu(z))
    out = (y @ p["out_proj"])[:, None]
    return out, {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C, "state": S}
