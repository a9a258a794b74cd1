"""Config-driven model assembly: init, forward, loss, train and serve steps
(port of ``repro.models.transformer``).

One code path serves every family of the reference:

* dense / vlm / audio — (attention + MLP) blocks, one per layer;
* moe — attention + capacity-based top-k MoE blocks (:mod:`.moe`);
* ssm — Mamba2 (SSD) blocks;
* hybrid (zamba2) — a Mamba2 stack with one *shared* attention+MLP block
  applied before every layer ``idx % shared_attn_every == 0`` (the shared
  parameters exist once, as in the reference).

The ``patch`` frontend (vlm) projects ``batch["vision_embeds"]`` over the
first positions of the token embeddings; the ``frames`` frontend (audio)
projects ``batch["frames"]`` and reads no tokens.

Parameters live in :class:`LMParams`, an ``nn.Module`` whose leaves are
``nn.Parameter``s under the reference's key names; the reference's stacked
per-layer leaves are an ``nn.ModuleList`` (layer ``i`` is the reference's
index ``i`` of the leading axis).  Decode carries KV caches (attention) and
conv/SSD states (mamba) in the reference's stacked layout and updates them
in place.  Training is masked next-token cross-entropy (:func:`loss_fn`)
through autograd; a gradient through the LM kernels runs their backward
kernels on the card.  :func:`make_train_step` updates the parameters in
place.

Tensor, expert and sequence parallelism: with DTensor parameters placed by
the reference's rules (``repro_torch.launch.mesh.place``) and
``ModelOptions(shard=ShardingPolicy(...))``, every function here runs the
reference's SPMD program, one process per card.  The embedding is a
``F.embedding`` lookup, vocab-parallel on a vocab-sharded table (indexing
would gather the table); ``hidden`` lays out the residual stream after the
embedding, after each block's row-parallel product (reducing its partial
sums, as the reference's partitioner does before the residual add) and
after each layer.  The loss is vocab-parallel where a mesh dim larger than
one shards the logits' vocabulary (:class:`_ShardedNLL`): each rank takes
the row maxima, the sums of exponentials and the label's logit over its
own columns and combines them with all-reduces over those dims, and its
gradient is its own columns' ``(onehot - softmax) * mask``, so no rank
forms a full-vocab row, forward or backward.  Elsewhere (no such dim, as
on a mesh of one rank) the rows go through aten's own ``log_softmax`` as
without a mesh, so a mesh of one rank is bitwise the no-mesh path
(``loss_parallel`` computes another log-softmax there).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core import prng
from ..device import resolve_device
from ..spmd import (block_of, full, is_dtensor, like, local_map, mesh_of, moved, placements_of,
                    redistribute, replicated, replicated_partials)
from .common import ModelOptions, constrain, dtype_of
from .layers import (
    apply_norm,
    attn_block,
    attn_block_decode,
    init_attn_block,
    init_mlp,
    mlp_block,
    param_dict,
)
from .moe import init_moe, moe_block
from .ssm import init_mamba_block, init_mamba_cache, mamba_block, mamba_block_decode

__all__ = [
    "LMParams",
    "init_params",
    "forward",
    "loss_fn",
    "init_cache",
    "serve_step",
    "make_train_step",
    "make_serve_step",
    "lm_params_from_jax",
]


#: The reference's optional top-level leaves besides ``shared``.
_OPTIONAL = ("final_norm", "lm_head", "vision_proj", "frame_proj")


class LMParams(nn.Module):
    """The reference's parameter pytree as a module: ``embed``, ``layers``
    (one ``nn.ModuleDict`` of ``nn.ParameterDict``s per layer), and the
    optional ``shared``, ``final_norm``, ``lm_head`` and the frontends'
    ``vision_proj`` / ``frame_proj``.  ``params[name]`` and
    ``params.get(name)`` read it as the reference reads its dict."""

    def __init__(self, embed: torch.Tensor, layers: List[nn.ModuleDict],
                 shared: Optional[nn.ModuleDict] = None,
                 final_norm: Optional[torch.Tensor] = None,
                 lm_head: Optional[torch.Tensor] = None,
                 vision_proj: Optional[torch.Tensor] = None,
                 frame_proj: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(layers)
        if shared is not None:
            self.shared = shared
        leaves = dict(final_norm=final_norm, lm_head=lm_head,
                      vision_proj=vision_proj, frame_proj=frame_proj)
        for name in _OPTIONAL:
            if leaves[name] is not None:
                setattr(self, name, nn.Parameter(leaves[name]))

    def get(self, name: str, default=None):
        return getattr(self, name, default)

    def __getitem__(self, name: str):
        value = self.get(name)
        if value is None:
            raise KeyError(name)
        return value


# ---------------------------------------------------------------------------
# Parameter init.
# ---------------------------------------------------------------------------

def _init_layer(cfg: ArchConfig, key, dtype) -> nn.ModuleDict:
    if cfg.family in ("ssm", "hybrid"):
        return nn.ModuleDict({"mamba": init_mamba_block(cfg, key, dtype)})
    k1, k2 = prng.split(key)
    block = (("moe", init_moe(cfg, k2, dtype)) if cfg.family == "moe"
             else ("mlp", init_mlp(cfg, k2, dtype)))
    return nn.ModuleDict(dict([("attn", init_attn_block(cfg, k1, dtype)), block]))


def init_params(cfg: ArchConfig, key, device=None) -> LMParams:
    """The reference's ``init_params`` on the port's threefry keys: ``key``
    is a ``(2,)`` key or an int seed (``PRNGKey(seed)``).  Layer ``i`` draws
    from ``split(keys[1], n_layers)[i]``, as the reference's ``vmap`` does,
    so a key names the reference's weights (normals to ``erfinv``'s
    rounding).  Tensors are drawn one at a time on ``device``."""
    if not isinstance(key, torch.Tensor):
        key = prng.PRNGKey(key, device=device)
    else:
        key = key.to(resolve_device(device))
    dtype = dtype_of(cfg.dtype)
    keys = prng.split(key, 8)

    def normal(k, shape):
        return (prng.normal(k, shape, torch.float32) * 0.02).to(dtype)

    embed = normal(keys[0], (cfg.padded_vocab, cfg.d_model))
    layer_keys = prng.split(keys[1], cfg.n_layers)
    layers = [_init_layer(cfg, layer_keys[i], dtype) for i in range(cfg.n_layers)]
    shared = None
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        shared = nn.ModuleDict({"attn": init_attn_block(cfg, keys[2], dtype),
                                "mlp": init_mlp(cfg, keys[3], dtype)})
    final_norm = (torch.ones(cfg.d_model, dtype=dtype, device=key.device)
                  if cfg.norm == "rmsnorm" else None)
    lm_head = (None if cfg.tie_embeddings
               else normal(keys[4], (cfg.d_model, cfg.padded_vocab)))
    vision_proj = (normal(keys[5], (cfg.frontend_dim, cfg.d_model))
                   if cfg.frontend == "patch" else None)
    frame_proj = (normal(keys[6], (cfg.frontend_dim, cfg.d_model))
                  if cfg.frontend == "frames" else None)
    return LMParams(embed, layers, shared, final_norm, lm_head, vision_proj,
                    frame_proj)


def _to_tensor(x, dtype, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact via float32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def lm_params_from_jax(params: Mapping[str, Any], *, dtype=None,
                       device=None) -> LMParams:
    """The reference's parameter pytree (a dict of numpy or jax arrays, with
    stacked per-layer leaves) as an :class:`LMParams` on ``device``;
    ``dtype`` (default: the arrays') converts.  A ``None`` leaf (the moe
    block's ``ln`` off rmsnorm) is left out, as ``init_moe`` leaves it."""
    device = resolve_device(device)
    unknown = set(params) - {"embed", "layers", "shared", *_OPTIONAL}
    if unknown:
        raise ValueError(f"unknown reference parameters {sorted(unknown)}")

    def tensors(tree):
        return {k: _to_tensor(v, dtype, device) for k, v in tree.items()
                if v is not None}

    stacked = {name: tensors(sub) for name, sub in params["layers"].items()}
    n_layers = next(iter(next(iter(stacked.values())).values())).shape[0]
    layers = [nn.ModuleDict({name: param_dict({k: v[i].clone() for k, v in sub.items()})
                             for name, sub in stacked.items()})
              for i in range(n_layers)]
    shared = None
    if "shared" in params:
        shared = nn.ModuleDict({name: param_dict(tensors(sub))
                                for name, sub in params["shared"].items()})
    opt = {k: _to_tensor(params[k], dtype, device) if k in params else None
           for k in _OPTIONAL}
    return LMParams(_to_tensor(params["embed"], dtype, device), layers, shared,
                    **opt)


# ---------------------------------------------------------------------------
# Forward (full sequence: prefill).
# ---------------------------------------------------------------------------

def _rows(tokens, embed, start: int):
    """Rows ``tokens - start`` of ``embed`` where they fall in it, zeros
    elsewhere (this rank's share of a vocab-parallel lookup)."""
    rel = tokens - start
    mine = (rel >= 0) & (rel < embed.shape[0])
    rows = F.embedding(torch.where(mine, rel, 0), embed)
    return torch.where(mine[..., None], rows, 0)


def _lookup(embed, tokens) -> torch.Tensor:
    """Rows ``tokens`` of ``embed``; vocab-parallel when ``embed`` is a
    DTensor sharded on the vocab: each rank looks up the rows it holds and
    the partial sums are reduced (the reference's sharded ``take``)."""
    mesh = mesh_of(embed)
    if mesh is None:
        return F.embedding(tokens, embed)
    from torch.distributed.tensor import Partial, Replicate, Shard

    pe, pt = embed.placements, placements_of(tokens, mesh)
    # a mesh dim that shards both the width (FSDP) and the tokens' rows
    # holds no block of the output: the width is gathered there
    pe = tuple(Replicate() if e.is_shard() and e.dim == 1 and not t.is_replicate() else e
               for e, t in zip(pe, pt))
    pt = tuple(Replicate() if e.is_shard() and e.dim == 0 else t for e, t in zip(pe, pt))
    out = tuple(Partial() if e.is_shard() and e.dim == 0 else
                Shard(tokens.dim()) if e.is_shard() else t for e, t in zip(pe, pt))
    start = block_of(embed, 0)[0]
    h = local_map(lambda t, e: _rows(t, e, start), mesh, (tokens, embed), (pt, pe), out)
    return replicated_partials(h)


def _embed_inputs(cfg: ArchConfig, params, batch) -> torch.Tensor:
    if cfg.frontend == "frames":
        proj = params["frame_proj"]
        return like(batch["frames"], proj) @ proj
    h = _lookup(params["embed"], batch["tokens"])
    if cfg.frontend == "patch" and "vision_embeds" in batch:
        proj = params["vision_proj"]
        vis = (like(batch["vision_embeds"], proj) @ proj).to(h.dtype)
        # the reference's dynamic_update_slice at (0, 0, 0)
        h = torch.cat([vis, h[:, vis.shape[1]:]], dim=1)
    return h


def _mask_pad_vocab(cfg, logits):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    col = like(torch.arange(logits.shape[-1], device=logits.device), logits)
    return torch.where(col < cfg.vocab, logits, -1e9)


def _layer_apply(cfg, opts, shared, h, layer_params, idx):
    """One layer (the reference's scanned body, its ``hidden`` constraint
    included); returns (h, the MoE aux increment: a float32 scalar for moe,
    else None)."""
    res = opts.shard.hidden  # a block's output in the residual's layout
    aux = None
    if cfg.family in ("ssm", "hybrid"):
        if (cfg.family == "hybrid" and cfg.shared_attn_every and shared is not None
                and idx % cfg.shared_attn_every == 0):
            h = h + res(attn_block(cfg, shared["attn"], h, opts))
            h = h + res(mlp_block(cfg, shared["mlp"], h, opts))
        h = h + res(mamba_block(cfg, layer_params["mamba"], h, opts))
    else:
        h = h + res(attn_block(cfg, layer_params["attn"], h, opts))
        if cfg.family == "moe":
            out, aux = moe_block(cfg, layer_params["moe"], h, opts)
            h = h + res(out)
        else:
            h = h + res(mlp_block(cfg, layer_params["mlp"], h, opts))
    return res(h), aux


def _head(cfg, params, h):
    h = apply_norm(cfg.norm, params.get("final_norm"), h)
    return h, (params["embed"].T if cfg.tie_embeddings else params["lm_head"])


def forward(
    cfg: ArchConfig,
    params: LMParams,
    batch: Mapping[str, torch.Tensor],
    opts: ModelOptions = ModelOptions(),
    head_positions: str = "all",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) — or (B, 1, V) for head_positions='last',
    the prefill case — and the MoE aux-loss scalar, summed over the layers;
    0 for the other families)."""
    h = opts.shard.hidden(_embed_inputs(cfg, params, batch))
    shared = params.get("shared")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # remat: each layer's activations are recomputed in the backward (the
    # reference's jax.checkpoint of its scanned body); nothing to recompute
    # on a pass without gradients
    remat = opts.remat and torch.is_grad_enabled()
    for idx, layer in enumerate(params.layers):
        if remat:
            h, aux_inc = checkpoint(_layer_apply, cfg, opts, shared, h, layer, idx,
                                    use_reentrant=False, preserve_rng_state=False)
        else:
            h, aux_inc = _layer_apply(cfg, opts, shared, h, layer, idx)
        if aux_inc is not None:
            aux = aux + aux_inc
    h, head = _head(cfg, params, h)
    if head_positions == "last":
        h = h[:, -1:, :]
    logits = _mask_pad_vocab(cfg, h @ head)
    if opts.logits_f32:
        logits = logits.float()
    return logits, aux


def _nll_sums(logits, labels, mask):
    """The masked log-likelihood's sum and the mask's sum."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.sum(ll * mask), torch.sum(mask)


class _ShardedNLL(torch.autograd.Function):
    """The masked log-likelihood sum of rows whose vocabulary is split over
    the process ``groups``: ``logits`` (..., V/n) holds this rank's columns
    from ``start``, ``labels`` the global ids.  The row max, the sum of
    ``exp(x - max)`` and the label's logit (a masked local gather, zero on
    the ranks that do not hold it) are reduced over ``groups``; the
    log-likelihood is ``(x[label] - max) - log(sum)``, as aten's
    log-softmax forms it.  The backward is this rank's columns of
    ``(onehot - softmax) * mask * upstream``: no collective, nothing of
    full-vocab width."""

    @staticmethod
    def forward(ctx, logits, labels, mask, start, groups):
        import torch.distributed as dist

        m = logits.amax(dim=-1)
        for g in groups:
            dist.all_reduce(m, dist.ReduceOp.MAX, group=g)
        m = torch.where(torch.isfinite(m), m, 0.0)  # a row of -inf: no nan
        total = torch.exp(logits - m[..., None]).sum(dim=-1)
        rel = labels - start
        mine = (rel >= 0) & (rel < logits.shape[-1])
        idx = torch.where(mine, rel, 0)[..., None]
        picked = torch.where(mine, torch.gather(logits, -1, idx)[..., 0], 0.0)
        for g in groups:
            dist.all_reduce(total, group=g)
            dist.all_reduce(picked, group=g)
        log_total = torch.log(total)
        ctx.save_for_backward(logits, m, log_total, idx, mine, mask)
        return torch.sum(((picked - m) - log_total) * mask)

    @staticmethod
    def backward(ctx, grad):
        logits, m, log_total, idx, mine, mask = ctx.saved_tensors
        out = -torch.exp((logits - m[..., None]) - log_total[..., None])
        out.scatter_add_(-1, idx, mine[..., None].to(out.dtype))
        return out * (mask * grad)[..., None], None, None, None, None


def _sharded_nll_sums(logits, labels, mask, start, groups):
    """:func:`_nll_sums` on this rank's vocabulary shard (:class:`_ShardedNLL`)."""
    return _ShardedNLL.apply(logits, labels, mask, start, groups), torch.sum(mask)


def _mesh_nll_sums(logits, labels, mask):
    """:func:`_nll_sums` of DTensor logits: vocab-parallel over the mesh dims
    larger than one that shard the vocabulary, each rank's rows as the
    logits shard them; without such a dim, every rank's rows over the
    whole vocabulary through :func:`_nll_sums`.  Both sums replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, vocab = logits.device_mesh, logits.dim() - 1
    split = [i for i, p in enumerate(logits.placements)
             if p.is_shard() and p.dim == vocab and mesh.size(i) > 1]
    if not split:
        rows = moved(logits.placements, {0: 0})
        sums = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
        return (replicated(t) for t in local_map(
            _nll_sums, mesh, (logits, labels, mask), (rows, rows, rows), [sums, sums]))
    rows = tuple(Shard(p.dim) if p.is_shard() and p.dim < vocab else Replicate()
                 for p in logits.placements)
    cols = tuple(Shard(vocab) if i in split else p for i, p in enumerate(rows))
    sums = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    start, groups = block_of(logits, vocab)[0], [mesh.get_group(i) for i in split]
    return (replicated(t) for t in local_map(
        lambda x, t, w: _sharded_nll_sums(x, t, w, start, groups), mesh,
        (logits, labels, mask), (cols, rows, rows), [sums, sums]))


def loss_fn(cfg: ArchConfig, params, batch, opts: ModelOptions = ModelOptions()):
    """Masked next-token cross-entropy over ``batch["labels"]`` and the
    optional ``batch["loss_mask"]`` (+0.01 * MoE aux / n_layers for moe).
    Under a mesh each rank sums its batch rows, over its vocabulary shard
    where the vocabulary is split (:func:`_mesh_nll_sums`); the loss is
    replicated."""
    logits, aux = forward(cfg, params, batch, opts)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    if mesh_of(logits) is None:
        num, den = _nll_sums(logits, labels, mask)
    else:
        num, den = _mesh_nll_sums(logits, labels, mask)
    loss = -num / torch.clamp(den, min=1.0)
    if cfg.family == "moe":
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss


# ---------------------------------------------------------------------------
# Decode (serve_step): one new token against a cache of length max_seq.
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None) -> Dict[str, Any]:
    """Zero caches in the reference's stacked layout (leading layer axis)."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim
    cache: Dict[str, Any] = {}
    if cfg.family in ("ssm", "hybrid"):
        one = init_mamba_cache(cfg, batch, dtype, device)
        cache["mamba"] = {k: v.new_zeros((cfg.n_layers,) + tuple(v.shape))
                          for k, v in one.items()}
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            n_inv = (cfg.n_layers + cfg.shared_attn_every - 1) // cfg.shared_attn_every
            cache["shared_k"] = torch.zeros(n_inv, batch, cfg.n_kv_heads, max_seq, hd,
                                            dtype=dtype, device=device)
            cache["shared_v"] = torch.zeros_like(cache["shared_k"])
    else:
        cache["k"] = torch.zeros(cfg.n_layers, batch, cfg.n_kv_heads, max_seq, hd,
                                 dtype=dtype, device=device)
        cache["v"] = torch.zeros_like(cache["k"])
    return cache


def _pin_cache(cache, opts: ModelOptions):
    """Lay each stacked cache leaf out as ``opts.cache_constraints`` pins
    its per-layer slices (the shared attention's by ``"k"``/``"v"``, as the
    reference's), in the dict; a leaf already so placed is kept, so the
    decode writes land in the caller's tensors."""
    pins = opts.cache_constraints
    if not pins:
        return

    def pin(name, x):
        return x if name not in pins else constrain(x, (None,) + tuple(pins[name]))

    for key, name in (("k", "k"), ("v", "v"), ("shared_k", "k"), ("shared_v", "v")):
        if key in cache:
            cache[key] = pin(name, cache[key])
    if "mamba" in cache:
        cache["mamba"] = {k: pin(k, v) for k, v in cache["mamba"].items()}


def serve_step(
    cfg: ArchConfig,
    params: LMParams,
    cache: Dict[str, Any],
    tokens: torch.Tensor,  # (B,) current token ids
    pos,  # int or 0-d integer tensor: index where this token sits
    opts: ModelOptions = ModelOptions(),
):
    """Decode one token; returns (logits (B, V) float32, cache).

    The caches are updated in place and the same dict is returned (the
    reference returns new arrays)."""
    h = opts.shard.hidden(_lookup(params["embed"], tokens[:, None]))  # (B, 1, D)
    res = opts.shard.hidden
    shared = params.get("shared")
    _pin_cache(cache, opts)
    if cfg.family in ("ssm", "hybrid"):
        mc = cache["mamba"]
        for idx, layer in enumerate(params.layers):
            if (cfg.family == "hybrid" and cfg.shared_attn_every
                    and idx % cfg.shared_attn_every == 0):
                inv = idx // cfg.shared_attn_every
                o, _, _ = attn_block_decode(cfg, shared["attn"], h,
                                            cache["shared_k"][inv],
                                            cache["shared_v"][inv], pos)
                h = h + res(o)
                h = h + res(mlp_block(cfg, shared["mlp"], h, ModelOptions()))
            out, new = mamba_block_decode(cfg, layer["mamba"], h,
                                          {k: v[idx] for k, v in mc.items()})
            for k, v in new.items():
                mc[k][idx].copy_(opts.constrain_cache(k, v))
            h = h + res(out)
    else:
        for idx, layer in enumerate(params.layers):
            o, _, _ = attn_block_decode(cfg, layer["attn"], h, cache["k"][idx],
                                        cache["v"][idx], pos)
            h = h + res(o)
            if cfg.family == "moe":
                h = h + res(moe_block(cfg, layer["moe"], h, opts)[0])
            else:
                h = h + res(mlp_block(cfg, layer["mlp"], h, opts))
    h, head = _head(cfg, params, h)
    logits = _mask_pad_vocab(cfg, h @ head)[:, 0].float()
    return logits, cache


# ---------------------------------------------------------------------------
# Step builders.
# ---------------------------------------------------------------------------

def settle(grad, like_):
    """A gradient in the layout of ``like_`` (its parameter or accumulation
    buffer): DTensor's backward leaves partial sums and other layouts,
    reduced here; a plain gradient is returned as it is."""
    if is_dtensor(like_):
        return redistribute(grad, like_.placements, like_.device_mesh)
    return grad


def apply_update(optimizer, params: LMParams, grads, opt_state):
    """One optimizer update written into ``params`` in place; returns the
    new optimizer state and the gradient norm (a plain tensor)."""
    leaves = list(params.parameters())
    new_p, opt_state, gnorm = optimizer.update(grads, opt_state,
                                               [p.detach() for p in leaves])
    with torch.no_grad():
        for p, v in zip(leaves, new_p):
            p.copy_(v)
    return opt_state, full(gnorm)


def make_train_step(cfg: ArchConfig, optimizer, opts: ModelOptions = ModelOptions()):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradients by autograd and one optimizer update.

    ``params`` is an :class:`LMParams`, updated in place and returned (as
    the port's ``make_sde_train_step`` updates its module); ``opt_state`` is
    ``optimizer.init(list(params.parameters()))``; ``batch`` holds device
    tensors ``tokens``, ``labels`` and optionally ``loss_mask``.
    ``metrics`` holds the device scalars ``loss`` and ``grad_norm``.
    DTensor parameters (:func:`repro_torch.launch.mesh.place`) are taken as
    they are: each gradient is settled into its parameter's layout before
    the update, which runs shard by shard.

    The step carries ``capturable = True``: it reads nothing back on the
    host (the optimizer's step count and schedule are device tensors, the
    kernels' scratch is allocated on each call, MoE routing sorts on the
    device), so :func:`repro_torch.train.train_loop` captures its chunks
    into CUDA graphs on the card."""

    def train_step(params, opt_state, batch):
        leaves = list(params.parameters())
        loss = loss_fn(cfg, params, batch, opts)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else settle(g, p)
                 for p, g in zip(leaves, grads)]
        opt_state, gnorm = apply_update(optimizer, params, grads, opt_state)
        return params, opt_state, {"loss": full(loss.detach()), "grad_norm": gnorm}

    train_step.capturable = True
    return train_step


def make_serve_step(cfg: ArchConfig, opts: ModelOptions = ModelOptions()):
    def step(params, cache, tokens, pos):
        return serve_step(cfg, params, cache, tokens, pos, opts)

    return step
