"""Plain PyTorch twin of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``): materialised causal GQA attention."""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "check_causal_shapes"]


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
