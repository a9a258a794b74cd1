"""Plain PyTorch twins of the flash-attention kernels (port of
``repro.kernels.flash_attention.ref``): materialised causal GQA attention,
and its backward written out step by step (the reference differentiates
``attention_ref`` with ``jax.grad``; :func:`attention_bwd_ref` is that
gradient in the order the backward kernel computes it)."""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "attention_bwd_ref", "check_causal_shapes"]


def check_causal_shapes(sq: int, sk: int, causal: bool) -> None:
    """Causal attention is defined here for ``sq == sk`` only: the
    reference's kernel masks top-left (``rows >= cols``) and its oracle
    bottom-right (``tril(k=sk-sq)``), which disagree when ``sq != sk``."""
    if causal and sq != sk:
        raise ValueError(
            f"causal attention needs seq_q == seq_k, got {sq} and {sk} (the "
            "reference's kernel and oracle mask a rectangular causal score "
            "matrix differently)")


def attention_ref(q, k, v, *, causal=True, sm_scale=None):
    """q: (b, hq, sq, d); k, v: (b, hk, sk, d); returns (b, hq, sq, d) in
    q's dtype, computed in float32."""
    b, hq, sq, d = q.shape
    _, hk, sk, _ = k.shape
    check_causal_shapes(sq, sk, causal)
    group = hq // hk
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * sm_scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_bwd_ref(q, k, v, out, d_out, *, causal=True, sm_scale=None):
    """The gradient of :func:`attention_ref` at ``(q, k, v)`` against the
    cotangent ``d_out`` of its output ``out``: returns ``(dq, dk, dv)`` in
    the inputs' dtypes, computed in float32 as the kernel computes it:

    * the float32 scores and their row statistics, recomputed: P;
    * dV = P^T dO and dP = dO V^T;
    * dS = P * (dP - rowsum(dO * O));
    * dQ = dS K * sm_scale and dK = dS^T Q * sm_scale;
    * dK and dV summed over each KV head's group of query heads.
    """
    b, hq, sq, d = q.shape
    _, hk, sk, _ = k.shape
    check_causal_shapes(sq, sk, causal)
    group = hq // hk
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = q.float()
    kr = torch.repeat_interleave(k.float(), group, dim=1)
    vr = torch.repeat_interleave(v.float(), group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * sm_scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    do = d_out.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vr)
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * sm_scale
    dk = dk.reshape(b, hk, group, sk, d).sum(dim=2)
    dv = dv.reshape(b, hk, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
