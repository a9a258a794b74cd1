"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors
over a fake world (port of ``repro.launch.dryrun``).

This is the proof that the distribution config is coherent without the
hardware: a fake process group of 256 ranks (``single``: a ``(16, 16)``
``("data", "model")`` mesh) or 512 (``multi``: ``(2, 16, 16)``) stands in
for a fleet of H100s, one rank a card, and the production step runs on
``FakeTensorMode``'s tensors laid out by ``launch/mesh.py``'s shardings:
rank 0's DTensor program, every op on the shapes of its local shards, and
no data anywhere.  The process makes the fake world itself (``run_cell``),
and refuses to run beside a real one.  It runs the plain path
(``use_flash="never"``): a fake tensor that reached a kernel would raise.

Two artifacts per cell:

1. **Memory module**: one trace of the production step (every layer,
   rematerialised, the microbatches of gradient accumulation, AdamW), with
   the live bytes of every storage followed op by op
   (:class:`~repro_torch.launch.roofline.CostCounter`).  Its peak is rank
   0's HBM use, held to the card's memory (``fits_hbm``); its wall time is
   ``compile_s``, and what it counted is ``full_module_cost``.

2. **Cost terms**: what the same trace counted.  An eager trace counts
   every layer it runs, so the reference's assembly from per-layer bodies
   (its compiler counted a loop's body once) is not needed for flops,
   bytes, collectives and transcendentals.  The reference's per-layer
   modules (``_layer_apply`` at ``idx=1``, the shared ``attn_block`` +
   ``mlp_block``) are traced on their own with real and with stubbed
   sequence mixing (``attn_impl="stub"``) for ``bytes_kernel``: the plain
   bodies' bytes swapped for the stubs' plus the fused kernels' analytic
   I/O (4.5x a training layer, 1x a prefill one).  At ``S >= 16384`` a
   prefill attention body is the stub plus the analytic score work, as the
   reference costs it.

Every count is rank 0's, per device, as the reference's are.  The
datasheet constants of :mod:`repro_torch.launch.roofline` turn them into
predicted times: the records are predictions, not measurements.

Usage::

  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --variant v2

Records land in ``launch_results_torch/<mesh>/<arch>__<shape>__<variant>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Dict, Tuple

import torch

from repro_torch.configs import (ALL_SHAPES, ArchConfig, ShapeSpec, cell_applicable,
                                 get_arch, get_shape, list_archs)
from repro_torch.launch.mesh import (
    PartitionSpec as P,
    Sharding,
    _leaf_spec,
    _safe,
    axis_size,
    batch_axes,
    batch_pspecs,
    cache_pspecs,
    cache_shardings,
    make_production_mesh,
    opt_state_shardings,
    param_shardings,
    place,
)
from repro_torch.launch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS, CostCounter,
                                         memory_summary)
from repro_torch.spmd import placements_for

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "launch_results_torch")
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 at 700.00 W (chip_smoke.py phase 22 prints it)
HBM_BUDGET = 85_017_493_504
# layer-boundary activations' share of the card: a quarter, as the
# reference's 4 GiB is of v5e's 16 GiB
ACT_BUDGET = HBM_BUDGET // 4

# ---------------------------------------------------------------------------
# Cell configuration heuristics.
# ---------------------------------------------------------------------------

def _n_devices(mesh) -> int:
    names = tuple(mesh.mesh_dim_names) if hasattr(mesh, "mesh_dim_names") else tuple(mesh.shape)
    return axis_size(mesh, names)


def _dp(mesh) -> int:
    return axis_size(mesh, batch_axes(mesh))


def microbatches_for(cfg, shape, mesh, *, budget: int = ACT_BUDGET) -> int:
    """Gradient-accumulation factor so layer-boundary activations fit
    ``budget`` bytes (default a quarter of the card; the reference's 4 GiB
    is ``budget=4 * 2**30``)."""
    if shape.kind != "train":
        return 1
    b_loc = max(shape.global_batch // _dp(mesh), 1)
    bound = cfg.n_layers * b_loc * shape.seq_len * cfg.d_model * 2  # bf16 carriers
    if cfg.family == "moe":
        # dispatch/scatter working set (xe + gate/up/down + bwd copies) is a
        # multiple of the token volume through the experts
        bound *= 4
    k = max(1, (bound + budget - 1) // budget)
    while b_loc % k != 0:  # must divide the local batch
        k += 1
    return min(k, b_loc)


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A model input's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _cfg(arch) -> ArchConfig:
    return get_arch(arch) if isinstance(arch, str) else arch


def _shape(shape) -> ShapeSpec:
    return get_shape(shape) if isinstance(shape, str) else shape


def input_specs(arch, shape_name, *, microbatches: int = 1):
    """:class:`ShapeDtype` stand-ins for every model input of a cell
    (``arch`` and ``shape_name`` a name or the config itself)."""
    cfg = _cfg(arch)
    shape = _shape(shape_name)
    B, S = shape.global_batch, shape.seq_len
    f32, i32, bf16 = torch.float32, torch.int32, torch.bfloat16

    def mb(shp):
        if microbatches > 1:
            return (microbatches, shp[0] // microbatches) + shp[1:]
        return shp

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "frames":
            batch = {"frames": ShapeDtype(mb((B, S, cfg.frontend_dim)), bf16)}
        else:
            batch = {"tokens": ShapeDtype(mb((B, S)), i32)}
            if cfg.frontend == "patch":
                batch["vision_embeds"] = ShapeDtype(
                    mb((B, cfg.n_vision_tokens, cfg.frontend_dim)), bf16)
        if shape.kind == "train":
            batch["labels"] = ShapeDtype(mb((B, S)), i32)
            batch["loss_mask"] = ShapeDtype(mb((B, S)), f32)
        return batch
    return {"tokens": ShapeDtype((B,), i32), "pos": ShapeDtype((), i32)}


def _opts(mesh, *, seq_shard: bool = False, cache_constraints=None,
          attn_chunk: int = 512):
    from repro_torch.models import ModelOptions, ShardingPolicy

    return ModelOptions(
        remat=True,
        use_flash="never",  # fake tensors reach no kernel; the card runs them
        attn_chunk=attn_chunk,
        shard=ShardingPolicy(
            batch_axes=None if seq_shard else batch_axes(mesh),
            model_axis="model",
            seq_axes=batch_axes(mesh) if seq_shard else None,
        ),
        cache_constraints=cache_constraints,
    )


# ---------------------------------------------------------------------------
# The fake world and abstract inputs.
# ---------------------------------------------------------------------------

def fake_world(n_ranks: int) -> None:
    """A fake process group of ``n_ranks`` ranks, this process rank 0: it
    runs no collective (``FakeStore``, backend ``"fake"``), so one process
    runs rank 0's program of an ``n_ranks`` fleet.  A fake group of another
    size is replaced; a real one raises ``ValueError``."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError(
                f"a {dist.get_backend()!r} process group of {dist.get_world_size()} "
                "ranks exists: the dry run runs in a process of its own, on a fake world")
        if dist.get_world_size() == n_ranks:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)


def fake_device() -> str:
    """The dry run's device: ``"cuda"``, the production device, where a
    card is present (fake tensors take none of its memory); ``"cpu"``
    elsewhere (a CPU-only build's fake CUDA tensors take no view).  Shapes,
    dtypes and the op sequence are the same on both."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@functools.lru_cache(maxsize=None)
def _meta_layer(cfg):
    """A one-layer :class:`~repro_torch.models.LMParams` of ``cfg`` (its
    ``n_layers`` set to 1) as meta tensors, by the port's own init with its
    key splits and normal draws left empty: the leaves' shapes and dtypes
    (the reference's ``jax.eval_shape(init_params)``)."""
    from unittest import mock

    from torch.utils._python_dispatch import _disable_current_modes

    from repro_torch.core import prng
    from repro_torch.models import init_params

    def split(key, num=2):
        return key.new_empty(tuple(key.shape[:-1]) + (num, 2))

    def normal(key, shape, dtype=torch.float32):
        return torch.empty(tuple(key.shape[:-1]) + tuple(shape), dtype=dtype, device="meta")

    # meta tensors, outside any fake mode
    with _disable_current_modes(), mock.patch.object(prng, "split", split), \
            mock.patch.object(prng, "normal", normal):
        return init_params(cfg, 0, device="meta")


def abstract_params(cfg, device):
    """An :class:`~repro_torch.models.LMParams` of ``cfg`` with empty
    leaves on ``device`` (fake tensors under ``FakeTensorMode``): the
    reference's ``jax.eval_shape(init_params)``."""
    from torch import nn

    from repro_torch.models import LMParams
    from repro_torch.models.layers import param_dict

    one = _meta_layer(dataclasses.replace(cfg, n_layers=1))

    def empty(t):
        return torch.empty(t.shape, dtype=t.dtype, device=device)

    def block(module):
        return nn.ModuleDict({g: param_dict({k: empty(v) for k, v in sub.items()})
                              for g, sub in module.items()})

    shared = one.get("shared")
    opt = {k: empty(one.get(k)) if one.get(k) is not None else None
           for k in ("final_norm", "lm_head", "vision_proj", "frame_proj")}
    return LMParams(empty(one.embed), [block(one.layers[0]) for _ in range(cfg.n_layers)],
                    block(shared) if shared is not None else None, **opt)


def _materialize(specs, device):
    """Tensors of ``specs`` (a dict of :class:`ShapeDtype`): token 0
    everywhere, every float input (the loss mask, embeddings) 1."""
    return {k: (torch.ones if v.dtype.is_floating_point else torch.zeros)(
        v.shape, dtype=v.dtype, device=device) for k, v in specs.items()}


def _place_tree(mesh, tree, specs):
    """Each tensor of the dict ``tree`` laid out by its spec."""
    return {k: place(v, Sharding(mesh, placements_for(mesh, specs[k]))) for k, v in tree.items()}


def _abstract_layer(cfg):
    """One layer's leaves as meta tensors, ``{group: {name: tensor}}``."""
    layer = _meta_layer(dataclasses.replace(cfg, n_layers=1)).layers[0]
    return {g: dict(sub.items()) for g, sub in layer.items()}


def _layer_specs(cfg, mesh, fsdp, al=None):
    al = _abstract_layer(cfg) if al is None else al
    return {g: {k: _leaf_spec(mesh, k, tuple(v.shape), fsdp="data" if fsdp else None,
                              stacked=False) for k, v in sub.items()}
            for g, sub in al.items()}


# ---------------------------------------------------------------------------
# Building a cell's step.
# ---------------------------------------------------------------------------

def _build(cfg, shape, mesh, *, fsdp, zero1, mb, accum_dtype, device, params=None):
    """The production step of ``cfg`` (its depth as given) and its inputs on
    ``mesh``: ``(step, args)``; ``params`` (default: empty ones) are laid
    out in place."""
    from repro_torch.models import init_cache, serve_step
    from repro_torch.models.transformer import forward
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import make_accum_train_step

    B, S = shape.global_batch, shape.seq_len
    seq_shard = shape.kind != "decode" and (B // mb) % _dp(mesh) != 0
    opts = _opts(mesh, seq_shard=seq_shard)
    if params is None:
        params = abstract_params(cfg, device)
    place(params, param_shardings(mesh, params, fsdp=fsdp))
    specs = input_specs(cfg, shape, microbatches=mb)
    ba = batch_axes(mesh)

    if shape.kind == "train":
        optimizer = adamw(cosine_schedule(3e-4, 2000, 100_000))
        opt_state = optimizer.init(list(params.parameters()))
        if zero1:
            opt_state = place(opt_state, opt_state_shardings(mesh, params, fsdp=fsdp,
                                                             zero1=True))

        # microbatched batch leaves: (mb, B/mb, S...) -> batch axis is dim 1
        def bspec(leaf):
            dims = len(leaf.shape)
            if mb > 1 or (seq_shard and dims >= 2):
                entries = (None, ba) + (None,) * (dims - 2)
            else:
                entries = (ba,) + (None,) * (dims - 1)
            return _safe(mesh, leaf.shape, entries)

        batch = _place_tree(mesh, _materialize(specs, device),
                            {k: bspec(v) for k, v in specs.items()})
        grad_constraint = None
        if zero1:
            # ZeRO-2: reduce-scatter grads into a data-sharded accumulator
            gsh = opt_state_shardings(mesh, params, fsdp=fsdp, zero1=True).mu

            def grad_constraint(bufs):
                return place(bufs, gsh)
        step = make_accum_train_step(cfg, optimizer, opts, microbatches=mb,
                                     accum_dtype=accum_dtype, grad_constraint=grad_constraint)
        return step, (params, opt_state, batch)

    if shape.kind == "prefill":
        batch = _place_tree(mesh, _materialize(specs, device),
                            batch_pspecs(mesh, specs, seq_shard=seq_shard))

        def prefill(params, batch):
            with torch.no_grad():
                return forward(cfg, params, batch, opts, head_positions="last")[0]

        return prefill, (params, batch)

    # decode
    cache = init_cache(cfg, B, S, device=device)
    cache = place(cache, cache_shardings(mesh, cache, batch=B)[0])
    d_opts = _opts(mesh, cache_constraints=_decode_cache_constraints(cfg, mesh, B, S))
    batch_ok = B % _dp(mesh) == 0 and B > 1
    if not batch_ok:
        d_opts = dataclasses.replace(d_opts, shard=dataclasses.replace(
            d_opts.shard, batch_axes=None))
    tokens = _place_tree(mesh, {"tokens": torch.zeros(B, dtype=torch.int32, device=device)},
                         {"tokens": P(ba) if batch_ok else P(None)})["tokens"]
    pos = torch.zeros((), dtype=torch.int32, device=device)

    def decode(params, cache, tokens, pos):
        with torch.no_grad():
            return serve_step(cfg, params, cache, tokens, pos, d_opts)

    return decode, (params, cache, tokens, pos)


def _accum_dtype(cfg):
    # bf16 grad accumulation for >16B-param models (buffer halving; §Perf)
    return torch.bfloat16 if cfg.param_count() > 16e9 else torch.float32


def build_cell(arch, shape_name, mesh, *, fsdp: bool = True, zero1: bool = False,
               params=None):
    """``(step, args, microbatches)``: the production step of a cell and its
    inputs laid out on ``mesh``, created on :func:`fake_device` under the
    caller's mode (fake tensors inside ``FakeTensorMode``).  ``arch`` and
    ``shape_name`` are names or the config objects themselves; ``params``,
    an :class:`~repro_torch.models.LMParams` of real weights, takes the
    place of empty ones (the same step run for real)."""
    cfg, shape = _cfg(arch), _shape(shape_name)
    mb = microbatches_for(cfg, shape, mesh)
    step, args = _build(cfg, shape, mesh, fsdp=fsdp, zero1=zero1, mb=mb,
                        accum_dtype=_accum_dtype(cfg), device=fake_device(), params=params)
    return step, args, mb


# ---------------------------------------------------------------------------
# Traces and cost terms.
# ---------------------------------------------------------------------------

def _trace(fn, args, mesh, *, track_memory: bool = False):
    """``(counter, result)`` of ``fn(*args)`` under a fresh
    :class:`CostCounter` inside ``mesh`` (the ambient mesh of the model's
    sharding hooks)."""
    counter = CostCounter(track_memory=track_memory)
    with mesh, counter:
        out = fn(*args)
    return counter, out


def _n_shared(cfg) -> int:
    """The hybrid's shared-block invocations (0 for the other families)."""
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        return (cfg.n_layers + cfg.shared_attn_every - 1) // cfg.shared_attn_every
    return 0


def _placed_layer(cfg, mesh, fsdp, device):
    """One layer's parameters (and the hybrid's shared block) as placed in
    the production step."""
    params = abstract_params(dataclasses.replace(cfg, n_layers=1), device)
    place(params, param_shardings(mesh, params, fsdp=fsdp))
    return params.layers[0], params.get("shared")


def _body_costs(cfg, shape, mesh, *, fsdp, mb) -> Dict[str, Dict[str, float]]:
    """The reference's per-layer cost modules, each traced on its own at the
    cell's microbatch shape: the layer at ``idx=1`` (and the shared block),
    forward and forward + backward, with real and with stubbed sequence
    mixing."""
    from repro_torch.models.layers import attn_block, mlp_block
    from repro_torch.models.transformer import _layer_apply

    B, S = shape.global_batch, shape.seq_len
    b_mb = max(B // mb, 1)
    device = fake_device()
    opts = _opts(mesh)  # the production step's attention chunks
    stub = dataclasses.replace(opts, attn_impl="stub")
    lp, sp = _placed_layer(cfg, mesh, fsdp, device)
    ba = batch_axes(mesh)

    def hidden():
        h = torch.zeros(b_mb, S, cfg.d_model, dtype=torch.bfloat16, device=device)
        return place(h, Sharding(mesh, placements_for(mesh, (ba, None, None), h.shape)))

    def body(o):
        return lambda h, p: _layer_apply(cfg, o, None, h, p, 1)[0]

    def shared(o):
        def fn(h, p):  # the shared block as _layer_apply runs it
            h = h + o.shard.hidden(attn_block(cfg, p["attn"], h, o))
            return h + o.shard.hidden(mlp_block(cfg, p["mlp"], h, o))
        return fn

    def fwd(fn):
        def run(h, p):
            with torch.no_grad():
                return fn(h, p)
        return run

    def vjp(fn):
        def run(h, ct, p):
            h = h.detach().requires_grad_(True)
            leaves = [h] + list(p.parameters())
            return torch.autograd.grad(fn(h, p), leaves, ct, allow_unused=True)
        return run

    def cost(fn, *args):
        return _trace(fn, args, mesh)[0].cost()

    out = {}
    train = shape.kind == "train"
    for name, make, p in (("layer", body, lp), ("shared", shared, sp)):
        if p is None:
            continue
        h = hidden()
        out[name + "_stub_fwd"] = cost(fwd(make(stub)), h, p)
        attention = name == "shared" or cfg.family not in ("ssm", "hybrid")
        if shape.kind == "prefill" and S >= 16384 and attention:
            # the reference's stand-in for a score tensor its compiler could
            # not unroll: the stub plus the attention's analytic work
            c_fwd = dict(out[name + "_stub_fwd"])
            c_fwd["flops"] += _attn_flops(cfg, b_mb, S, _n_devices(mesh))
            c_fwd["bytes"] += _attn_score_bytes(cfg, b_mb, S, _n_devices(mesh))
            out[name + "_fwd"] = c_fwd
        else:
            out[name + "_fwd"] = cost(fwd(make(opts)), h, p)
        if train:
            out[name + "_vjp"] = cost(vjp(make(opts)), h, hidden(), p)
            out[name + "_stub_vjp"] = cost(vjp(make(stub)), h, hidden(), p)
    return out


def build_cost_terms(cfg, shape, mesh, *, fsdp: bool, microbatches: int,
                     full_cost: Dict[str, float]) -> Dict[str, float]:
    """The cell's per-rank flops, bytes, collective bytes and
    transcendentals, which are the full trace's ``full_cost`` (an eager
    trace counts every layer it runs; the reference assembles them from
    bodies because its compiler counted a loop's body once), and
    ``bytes_kernel``: the traffic of the kernel path, the plain sequence
    mixing's bytes swapped for the stub's plus the fused kernels' analytic
    I/O."""
    B, S = shape.global_batch, shape.seq_len
    L, mb = cfg.n_layers, microbatches
    total = dict(full_cost)
    if shape.kind == "decode":
        total["bytes_kernel"] = total["bytes"]
        return total
    b_mb = max(B // mb, 1)
    n_dev = _n_devices(mesh)
    body = _body_costs(cfg, shape, mesh, fsdp=fsdp, mb=mb)
    n_inv = _n_shared(cfg)
    train = shape.kind == "train"
    factor = 4.5 if train else 1.0  # the reference's kernel-I/O passes a layer
    # the sequence mixing's HBM traffic the fused kernels eliminate
    # (materialised attention scores / SSD segment matrices): the kernel-path
    # bytes are the stub's plus the kernels' own I/O; flops are the same
    runs = (("layer", L * mb, _seq_mix_io_bytes(cfg, b_mb, S, n_dev)),
            ("shared", n_inv * mb, _attn_io_bytes(cfg, b_mb, S, n_dev)))
    outside, kernel_bytes = total["bytes"], 0.0
    for name, count, kio in runs:
        if name + "_fwd" not in body:
            continue
        plain = body[name + "_fwd"]["bytes"]
        stubbed = body[name + "_stub_fwd"]["bytes"]
        if train:
            plain += body[name + "_vjp"]["bytes"]
            stubbed += body[name + "_stub_vjp"]["bytes"]
        outside -= plain * count
        kernel_bytes += (stubbed + factor * kio) * count
    total["bytes_kernel"] = kernel_bytes + max(outside, 0.0)
    return total


def _attn_flops(cfg, b, S, n_devices) -> float:
    """Full (non-causal-skip) attention flops per device: qk + pv."""
    return 4.0 * b * cfg.n_heads * S * S * cfg.resolved_head_dim / n_devices


def _attn_score_bytes(cfg, b, S, n_devices) -> float:
    """Fallback-path score-matrix traffic per device (s write + softmax r/w +
    p read: ~4 passes of the f32 (b, H, S, S) tensor)."""
    return 4.0 * b * cfg.n_heads * S * S * 4.0 / n_devices


def _attn_io_bytes(cfg, b, S, n_devices) -> float:
    """Per-(layer, microbatch, device) flash-attention HBM I/O: q/k/v/o stream
    once in bf16; running stats negligible."""
    hd = cfg.resolved_head_dim
    elems = b * S * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    return 2.0 * elems / n_devices


def _ssd_io_bytes(cfg, b, S, n_devices) -> float:
    di, ds = cfg.d_inner, cfg.ssm_state
    elems = b * S * (2 * di + 2 * ds + cfg.ssm_heads)
    return 4.0 * elems / n_devices  # f32 path of the SSD kernel


def _seq_mix_io_bytes(cfg, b, S, n_devices) -> float:
    if cfg.family in ("ssm", "hybrid"):
        return _ssd_io_bytes(cfg, b, S, n_devices)
    return _attn_io_bytes(cfg, b, S, n_devices)


def _local_bytes(tree, specs, mesh) -> float:
    """Per-device bytes of a sharded tree (leaf size / sharded axis sizes):
    ``tree`` a nest of dicts of tensors, ``specs`` the same nest of
    :class:`~repro_torch.launch.mesh.PartitionSpec`."""
    if isinstance(specs, P):
        shard = 1
        for entry in tuple(specs):
            shard *= axis_size(mesh, entry)
        return tree.numel() * tree.element_size() / max(shard, 1)
    return sum(_local_bytes(tree[k], specs[k], mesh) for k in sorted(specs))


def _analytic_memory_bytes(cfg, shape, mesh, *, microbatches, al, l_specs) -> float:
    """Fusion-aware HBM-traffic model (the post-fusion estimate):

        per layer/microbatch: 4x weight-shard (fwd read, remat read, bwd read,
        grad write) + C x activation-boundary tensors (C ~= 45 train / 12
        prefill, counting q/k/v/o, mlp gate/up/down, norms, residuals across
        fwd + bwd + remat-fwd) + fused-kernel I/O;
        outside: logits traffic (~6 passes) + embedding + optimizer sweep.

    The counted bytes are pre-fusion (every op's operands), a ~10x
    overestimate for fused pipelines; this model is what the roofline's
    dominance classification uses, with both counted variants beside it.
    """
    B, S = shape.global_batch, shape.seq_len
    dp = _dp(mesh)
    L = cfg.n_layers
    mb = microbatches
    n_dev = _n_devices(mesh)
    b_loc = max(B // mb // dp, 1)
    w_loc = _local_bytes(al, l_specs, mesh)
    act = b_loc * S * cfg.d_model * 2.0
    train = shape.kind == "train"
    c_act = 45.0 if train else 12.0
    c_w = 4.0 if train else 1.0
    kio = _seq_mix_io_bytes(cfg, max(B // mb, 1), S, n_dev) * (4.5 if train else 1.0)
    per_layer = c_w * w_loc + c_act * act + kio
    total = per_layer * L * mb
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        n_inv = (L + cfg.shared_attn_every - 1) // cfg.shared_attn_every
        total += per_layer * n_inv * mb  # same order as a dense layer
    # outside: logits + embed + optimizer sweep (per device)
    model = axis_size(mesh, "model")
    v_shard = cfg.padded_vocab // max(1, model if cfg.padded_vocab % model == 0 else 1)
    logits = b_loc * S * v_shard * 4.0 * (6.0 if train else 1.0) * mb
    embed = cfg.padded_vocab * cfg.d_model * 2.0 / n_dev * (3.0 if train else 1.0)
    opt = 0.0
    if train:
        n_params_loc = cfg.param_count() * 2.0 / model
        opt = 7.0 * n_params_loc  # p r/w, m r/w, v r/w (f32~2x bf16), grads read
    return total + logits + embed + opt


def _decode_cache_constraints(cfg, mesh, B, S):
    """Per-layer cache specs (leading layer axis stripped), by leaf name; the
    shared attention's caches go by ``"k"`` and ``"v"``."""
    from repro_torch.models import init_cache

    cache = init_cache(cfg, B, S, device="meta")
    full = cache_pspecs(mesh, cache, batch=B)
    flat = dict(full.get("mamba", {}))
    for key in ("k", "v", "shared_k", "shared_v"):
        if key in full:
            flat[key[-1]] = full[key]
    return {name: P(*tuple(spec)[1:]) for name, spec in flat.items()}


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N_active D for train; 2 N_active D for inference."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


# ---------------------------------------------------------------------------
# Cell runner.
# ---------------------------------------------------------------------------

def _mesh_for(mesh_kind: str):
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device=fake_device())


def run_cell(arch, shape_name, mesh_kind: str, *, fsdp: bool = True,
             variant: str = "v2", cost: bool = True, mesh=None) -> dict:
    """The record of one cell: rank 0's memory module on ``mesh_kind``'s
    production mesh over a fake world made here (or on ``mesh``, a mesh the
    caller made over its own world), and, with ``cost``, its roofline."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, shape = _cfg(arch), _shape(shape_name)
    arch, shape_name = cfg.name, shape.name
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "variant": variant, "status": "skipped", "reason": reason}
    zero1 = variant.startswith("v3")
    if zero1:
        fsdp = False  # ZeRO-1: TP-only params, data-sharded moments
    t0 = time.time()
    if mesh is None:
        mesh = _mesh_for(mesh_kind)
    n_dev = _n_devices(mesh)
    with FakeTensorMode():
        step, args, mb = build_cell(cfg, shape, mesh, fsdp=fsdp, zero1=zero1)
        counter, out = _trace(step, args, mesh, track_memory=True)
        mem = memory_summary(counter, arguments=args, outputs=out)
        full_cost = counter.cost()
        del step, args, out
        t_mem = time.time() - t0
        rec = {
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_kind,
            "variant": variant,
            "status": "ok",
            "n_devices": n_dev,
            "microbatches": mb,
            "fsdp": fsdp,
            "compile_s": round(t_mem, 1),
            "memory": mem,
            "fits_hbm": mem["total_hbm_bytes"] <= HBM_BUDGET,
            "full_module_cost": full_cost,
        }
        if cost:
            terms = build_cost_terms(cfg, shape, mesh, fsdp=fsdp, microbatches=mb,
                                     full_cost=full_cost)
            rec["roofline"] = _roofline(cfg, shape, mesh, terms, mb, n_dev)
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def _roofline(cfg, shape, mesh, terms, mb, n_dev) -> dict:
    mf = model_flops_for(cfg, shape)
    compute_s = terms["flops"] / PEAK_FLOPS
    memory_s = terms["bytes"] / HBM_BW
    memory_s_kernel = terms.get("bytes_kernel", terms["bytes"]) / HBM_BW
    al = _abstract_layer(cfg)
    analytic_bytes = _analytic_memory_bytes(
        cfg, shape, mesh, microbatches=mb, al=al, l_specs=_layer_specs(cfg, mesh, False, al))
    memory_s_analytic = analytic_bytes / HBM_BW if shape.kind != "decode" else memory_s_kernel
    collective_s = terms["coll"] / LINK_BW
    tdict = {"compute": compute_s, "memory": memory_s_analytic, "collective": collective_s}
    dominant = max(tdict, key=tdict.get)
    return {
        "flops": terms["flops"],
        "bytes_accessed": terms["bytes"],
        "bytes_accessed_kernel": terms.get("bytes_kernel", terms["bytes"]),
        "coll_bytes": terms["coll"],
        "transcendentals": terms["transcendentals"],
        "compute_s": compute_s,
        "memory_s_hlo_prefusion": memory_s,
        "memory_s_kernel_prefusion": memory_s_kernel,
        "memory_s": memory_s_analytic,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / (terms["flops"] * n_dev) if terms["flops"] else None,
        "peak_fraction": compute_s / max(max(tdict.values()), 1e-30),
    }


def _path(mesh_kind, arch, shape_name, variant) -> str:
    suffix = "" if variant in ("baseline", "") else f"__{variant}"
    return os.path.join(os.path.abspath(RESULTS_DIR), mesh_kind,
                        f"{arch}__{shape_name}{suffix}.json")


def save(rec: dict):
    path = _path(rec["mesh"], rec["arch"], rec["shape"], rec.get("variant", "baseline"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--variant", default="v2")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for a in list_archs():
            for s in ALL_SHAPES:
                cells.append((a, s.name))
    else:
        cells.append((args.arch, args.shape))

    n_ok = n_skip = n_fail = 0
    for mesh_kind in meshes:
        for arch, shape_name in cells:
            if args.skip_existing and os.path.exists(
                    _path(mesh_kind, arch, shape_name, args.variant)):
                print(f"[skip-existing] {mesh_kind} {arch} {shape_name}", flush=True)
                continue
            try:
                rec = run_cell(arch, shape_name, mesh_kind, fsdp=not args.no_fsdp,
                               variant=args.variant, cost=not args.no_cost)
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                       "variant": args.variant, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            save(rec)
            tag = rec["status"]
            n_ok += tag == "ok"
            n_skip += tag == "skipped"
            n_fail += tag == "error"
            extra = ""
            if tag == "ok":
                extra = (f" hbm={rec['memory']['total_hbm_bytes']/2**30:.2f}GiB"
                         f" fits={rec['fits_hbm']} mb={rec['microbatches']}")
                if "roofline" in rec:
                    r = rec["roofline"]
                    extra += (f" dom={r['dominant']} comp={r['compute_s']*1e3:.1f}ms"
                              f" mem={r['memory_s']*1e3:.1f}ms coll={r['collective_s']*1e3:.1f}ms"
                              f" useful={r['useful_ratio']:.2f}" if r.get("useful_ratio") else "")
            elif tag == "error":
                extra = " " + rec["error"][:160]
            print(f"[{tag}] {mesh_kind:6s} {arch:20s} {shape_name:12s}{extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} failed={n_fail}")


if __name__ == "__main__":
    main()
