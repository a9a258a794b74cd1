"""Mixture-of-Experts layer: top-k routing with fixed expert capacity (port of
``repro.models.moe``).

Dispatch is sort-based, as in the reference: each group's token->expert
assignments are ordered by expert with a stable sort, each expert takes its
first ``capacity`` tokens in token order (the overflow is dropped), runs a
SwiGLU on an ``(experts, groups * capacity, d)`` batch — one batched GEMM an
expert weight, every group's slots in it — and the results come back
weighted by the router's gate.

Routing is grouped per sequence when ``s * k >= experts`` (each batch row
sorts its own assignments, with a capacity per sequence) and one global
group otherwise (every decode tick).  The reference's ties resolve here as
they do there: top-k keeps the lower expert index of equal probabilities
(``jax.lax.top_k``), the sort is stable (``jnp.argsort``).

No float atomics, forward or backward: the dispatch gather and the combine
are index maps with their inverses (:class:`_GatherRows`), and every sum of
a token's ``k`` contributions runs over a ``k`` axis in index order, so a
step repeats its bits on the card.

Aux losses (load balancing, Switch-style, and the router z-loss) are
returned for the training objective: ``lb_loss + 1e-3 * z_loss`` in float32.

Under a mesh (expert parallelism) the expert weights ``(E, d, f)`` are
sharded on the experts; routing and the dispatch gather run on each rank's
tokens (data-sharded sequences when grouped, every token otherwise, as one
global group must see them all) with the reference's tie order, the
dispatch is laid out by ``moe_dispatch`` (experts on the model axis,
groups on the batch axes), each rank runs its experts' GEMMs, and the
combine reads the experts gathered back.  The aux statistics are means
over every rank's tokens.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng
from ..spmd import local_map, mesh_of, moved, placements_of, replicated
from .common import ModelOptions
from .layers import apply_norm, param_dict, scaled_normal

__all__ = ["init_moe", "moe_block"]


def init_moe(cfg, key, dtype) -> nn.ParameterDict:
    """The reference's draws: ``router`` float32 whatever ``dtype``; ``ln``
    only under rmsnorm."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    ks = prng.split(key, 4)
    sd_in, sd_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": scaled_normal(ks[0], (d, e), sd_in, torch.float32),
        "wg": scaled_normal(ks[1], (e, d, f), sd_in, dtype),
        "wu": scaled_normal(ks[2], (e, d, f), sd_in, dtype),
        "wd": scaled_normal(ks[3], (e, f, d), sd_out, dtype),
    }
    if cfg.norm == "rmsnorm":
        p["ln"] = torch.ones(d, dtype=dtype, device=key.device)
    return param_dict(p)


def _capacity(cfg, n_tokens: int) -> int:
    cap = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(cap, cfg.moe_top_k)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _GatherRows(torch.autograd.Function):
    """``src`` padded with a zero row, then rows ``index`` of it (the pad
    row, ``src.shape[-2]``, reads zeros), per group.  The backward is the
    inverse map: row ``r`` of the gradient sums ``back_k`` rows of the
    padded output gradient, ``back[..., r * back_k + j]`` for ``j`` in
    order (the pad index reads zeros) — a gather and a sum over a ``k``
    axis, no scatter-add.

    ``src`` (g, n, d); ``index`` (g, m) in [0, n]; ``back`` (g, n * back_k)
    in [0, m], naming every output row that reads source row ``r``."""

    @staticmethod
    def forward(ctx, src, index, back, back_k: int):
        ctx.save_for_backward(back)
        ctx.back_k = back_k
        return _take_rows(src, index)

    @staticmethod
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        g, n_k = back.shape
        rows = _take_rows(grad, back).view(g, n_k // ctx.back_k, ctx.back_k, -1)
        acc = rows[:, :, 0]
        for j in range(1, ctx.back_k):
            acc = acc + rows[:, :, j]
        return acc, None, None, None


def _take_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``index`` (g, m) of ``src`` (g, n, d) padded with a zero row."""
    padded = torch.cat([src, src.new_zeros(src.shape[0], 1, src.shape[2])], dim=1)
    return torch.gather(padded, 1, index[..., None].expand(-1, -1, src.shape[2]))


def _route(flat_expert: torch.Tensor, e: int, k: int, cap: int):
    """Slots of each group's assignments, ``flat_expert`` (g, n * k): the
    expert of assignment ``a`` (token ``a // k``, its ``a % k``-th choice).

    Returns ``slot`` (g, n * k), assignment ``a``'s row of the flattened
    (e * cap) dispatch, ``e * cap`` when dropped; ``token`` (g, e * cap), the
    token each slot holds (``n`` when empty); ``assignment`` (g, e * cap),
    the assignment each slot holds (``n * k`` when empty).  An expert holds
    its first ``cap`` assignments in assignment (token) order, as the
    reference's stable argsort and ``searchsorted(side="left")`` keep them."""
    g, nk = flat_expert.shape
    n = nk // k
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    experts = torch.arange(e, device=flat_expert.device).expand(g, e).contiguous()
    start = torch.searchsorted(sorted_expert, experts, side="left")  # (g, e)
    count = torch.searchsorted(sorted_expert, experts, side="right") - start
    pos = torch.arange(nk, device=flat_expert.device) - torch.gather(start, 1, sorted_expert)
    keep = pos < cap
    slot_sorted = torch.where(keep, sorted_expert * cap + pos, e * cap)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    # slot (ex, p) holds sorted assignment start[ex] + p when p < count[ex]
    p = torch.arange(cap, device=flat_expert.device)
    src = (start[:, :, None] + p).view(g, e * cap)
    full = (p < count[:, :, None]).view(g, e * cap)
    held = torch.gather(order, 1, src.clamp(max=nk - 1))
    assignment = torch.where(full, held, nk)
    token = torch.where(full, held // k, n)
    return slot, token, assignment


def _expert_major(slot, token, assignment, e: int, cap: int, n: int, k: int):
    """The groups' routing as one group over all ``g * n`` tokens, with the
    dispatch laid out expert-major: slot ``(ex, grp, pos)`` of ``(e, g, cap)``
    (so each expert's GEMM is one batch entry over every group's tokens, no
    broadcast copy of its weights); tokens and assignments numbered
    globally; the pad indices ``e * g * cap``, ``g * n`` and ``g * n * k``."""
    g = slot.shape[0]
    grp = torch.arange(g, device=slot.device)[:, None]
    ex, pos = torch.div(slot, cap, rounding_mode="floor"), slot % cap
    slot = torch.where(slot == e * cap, e * g * cap, (ex * g + grp) * cap + pos)
    token = torch.where(token == n, g * n, token + grp * n)
    assignment = torch.where(assignment == n * k, g * n * k, assignment + grp * n * k)
    # (g, e, cap) -> (e, g, cap)
    order = lambda x: x.view(g, e, cap).transpose(0, 1).reshape(1, -1)  # noqa: E731
    return slot.reshape(1, -1), order(token), order(assignment)


def _experts(p, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of each expert on its (e, tokens, d) batch."""
    gate_h = F.silu(torch.bmm(xe, p["wg"]))
    up_h = torch.bmm(xe, p["wu"])
    return torch.bmm(gate_h * up_h, p["wd"])


def _dispatch(h, router, e: int, k: int, cap: int, grouped: bool, shards: int = 1):
    """Routing and the dispatch gather of ``h`` (b, s, d) against ``router``
    (d, e): the dispatch ``xe`` (e, groups * cap, d), the normalised gates
    (b, s, k), the slot and assignment maps of :func:`_expert_major`, and
    the aux statistics (the router's mean probabilities, the experts' mean
    loads, the mean squared log-partition), each divided by ``shards``, the
    ranks whose tokens they average."""
    b, s, d = h.shape
    logits = h.float() @ router  # (b, s, e)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)  # (b, s, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=(0, 1)) / shards
    # Each token's picks counted per expert: one_hot's sum over k, without
    # one_hot, which reads its indices' range on the host off CUDA.
    picks = (gate_idx[..., None] == torch.arange(e, device=gate_idx.device)).sum(dim=2)
    ce = torch.mean(picks.float(), dim=(0, 1)) / shards
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) / shards

    groups, n = (b, s) if grouped else (1, b * s)
    slot, token, assignment = _expert_major(
        *_route(gate_idx.reshape(groups, n * k), e, k, cap), e, cap, n, k)
    xe = _GatherRows.apply(h.reshape(1, b * s, d), token, slot, k)
    return xe.view(e, groups * cap, d), gate_vals, slot, assignment, me, ce, zl


def _combine(down, gate_vals, slot, assignment):
    """Each token's ``k`` expert outputs, weighted by its gates and summed
    in index order: (b, s, d)."""
    b, s, k = gate_vals.shape
    e, d = down.shape[0], down.shape[-1]
    contrib = _GatherRows.apply(down.reshape(1, -1, d), slot, assignment, 1)
    contrib = contrib.view(b * s, k, d) * gate_vals.reshape(b * s, k, 1).to(down.dtype)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.reshape(b, s, d)


def moe_block(cfg, p, x: torch.Tensor, opts: ModelOptions = ModelOptions()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), aux loss scalar float32)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k

    h = apply_norm(cfg.norm, p.get("ln"), x)
    grouped = s * k >= e  # per-sequence groups when each row fills experts
    cap = _capacity(cfg, s if grouped else b * s)
    mesh = mesh_of(h, p["router"], p["wg"])
    if mesh is None:
        xe, gate_vals, slot, assignment, me, ce, zl = _dispatch(h, p["router"], e, k, cap,
                                                                grouped)
        if grouped:
            xe = opts.shard.moe_dispatch(xe)
        down = _experts(p, xe)
        if grouped:
            down = opts.shard.moe_dispatch(down)
        out = _combine(down, gate_vals, slot, assignment)
    else:
        from torch.distributed.tensor import Partial, Replicate, Shard

        # tokens: their data sharding when grouped (a group is a sequence),
        # every token on every rank otherwise (one global group)
        ph = tuple(Shard(0) if grouped and pl.is_shard() and pl.dim == 0 else Replicate()
                   for pl in placements_of(h, mesh))
        shards = 1
        for i, pl in enumerate(ph):
            shards *= mesh.size(i) if pl.is_shard() else 1
        stat = tuple(Partial() if pl.is_shard() else Replicate() for pl in ph)
        pd = moved(ph, {0: 1})
        xe, gate_vals, slot, assignment, me, ce, zl = local_map(
            lambda h, r: _dispatch(h, r, e, k, cap, grouped, shards), mesh,
            (h, p["router"]), (ph, (Replicate(),) * mesh.ndim),
            [pd, ph, None, None, stat, stat, stat])
        if grouped:
            xe = opts.shard.moe_dispatch(xe)
        # each rank's experts, as the expert weights are sharded (an FSDP
        # shard of their width is gathered)
        pw = [tuple(pl if pl.is_shard() and pl.dim == 0 else Replicate()
                    for pl in placements_of(p[n], mesh)) for n in ("wg", "wu", "wd")]
        pe = tuple(Shard(0) if w.is_shard() and w.dim == 0 else
                   Shard(1) if x_.is_shard() and x_.dim == 1 else Replicate()
                   for w, x_ in zip(pw[0], placements_of(xe, mesh)))
        down = local_map(lambda xe, wg, wu, wd: _experts({"wg": wg, "wu": wu, "wd": wd}, xe),
                         mesh, (xe, p["wg"], p["wu"], p["wd"]), (pe, *pw), pe)
        if grouped:
            down = opts.shard.moe_dispatch(down)
        out = local_map(_combine, mesh, (down, gate_vals, slot, assignment),
                        (moved(pe, {1: 1}), ph, None, None), ph)
        me, ce, zl = (replicated(t) for t in (me, ce, zl))
    lb_loss = e * torch.sum(me * ce) / k
    aux = (lb_loss + 1e-3 * zl).float()
    return out.to(x.dtype), aux
