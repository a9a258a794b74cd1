"""SPMD plumbing on ``torch.distributed.tensor`` (DTensor): the port's
counterpart of the reference's ``with_sharding_constraint`` and of running
a kernel on each device's shard.

Every rank runs the same program (one process per card).  A sharded value
is a ``DTensor`` on a ``DeviceMesh``; a plain tensor met beside one is the
same value on every rank (:func:`replicate`).  Specs are the reference's
``PartitionSpec`` entries, one per tensor dim (``None``, an axis name or a
tuple of axis names): :func:`placements_for` turns one into DTensor
placements, dropping a sharding whose axis size does not divide its dim,
as ``repro_torch.launch.mesh._safe`` does.

:func:`local_map` runs a function of plain tensors on each rank's local
shards, the way the hand-written kernels run under a mesh: the inputs are
redistributed to the placements the function needs and handed over with
``to_local``, the outputs rebuilt with ``from_local``.  Its backward
returns the gradient of an input that is replicated on a mesh dim the
outputs are sharded on as a ``Partial`` sum: every rank holds only its
shard's share of it.  :func:`gqa_map` is the layout of the attention
kernels over it (query heads sharded beside their KV group where the KV
heads do not divide the mesh dim), and :func:`batch_like` lays a decode's
q, k and v out on its cache's batch shard.

:func:`redistribute` is DTensor's, with two changes.  A reduction of
partial sums hands its gradient back replicated (DTensor's would mark it
partial, and the weight gradient of a row-parallel product would then
gather its other operand).  On CUDA tensors over gloo, whose functional
all-gather kills the process on torch 2.11 while its all-reduce runs,
shards are gathered by an all-reduce of zero-padded blocks (exact) and
the slices' backward gathers the same way.

Nothing here imports ``torch.distributed.tensor`` until a mesh is in use,
and no DTensor can exist before that import: :func:`is_dtensor` is a
module lookup and an ``isinstance`` on the no-mesh path.
"""
from __future__ import annotations

import math
import sys
from typing import Callable, Sequence

import torch

__all__ = ["is_dtensor", "mesh_of", "replicate", "like", "placements_for",
           "redistribute", "local_map", "local_shard", "full", "heads_layout", "gqa_map",
           "batch_like", "moved", "placements_of", "replicated", "replicated_partials",
           "block_of", "merge_last", "split_last"]


def is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_of(*xs):
    """The mesh of the first DTensor among ``xs``, else None."""
    for x in xs:
        if is_dtensor(x):
            return x.device_mesh
    return None


def replicate(t: torch.Tensor, mesh):
    """A plain tensor as the replicated DTensor it stands for on ``mesh``
    (every rank holds the same value; nothing is sent)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def like(t, ref):
    """``t`` as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor and ``t`` is not; ``t`` otherwise.  Tables the model builds
    beside a sharded activation (positions, masks, RoPE) go through this."""
    if is_dtensor(ref) and isinstance(t, torch.Tensor) and not is_dtensor(t):
        return replicate(t, ref.device_mesh)
    return t


def _axis_size(mesh, entry) -> int:
    names = tuple(mesh.mesh_dim_names)
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.size(names.index(a)) for a in axes)


def _normal(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def placements_for(mesh, spec, shape=None) -> tuple:
    """``spec`` as DTensor placements on ``mesh``: per mesh dim, ``Shard(i)``
    for the tensor dim ``i`` whose entry names that axis, else
    ``Replicate()``.  With ``shape``, an entry whose axes' size does not
    divide its dim is dropped first (the reference's ``_safe``), as is one
    on a dim of size 1 (one block holds it all; DTensor's reshapes refuse
    to squeeze a sharded dim), and a spec shorter than ``shape`` is padded
    with ``None``."""
    from torch.distributed.tensor import Replicate, Shard

    entries = [_normal(e) for e in spec]
    if shape is not None:
        entries += [None] * (len(shape) - len(entries))
        entries = [e if e is not None and dim > 1 and dim % _axis_size(mesh, e) == 0
                   else None for dim, e in zip(shape, entries)]
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(entries)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _gathers_by_all_reduce(mesh) -> bool:
    """Whether to gather shards with an all-reduce: on CUDA tensors over
    gloo, whose functional all-gather (the one DTensor issues) kills the
    process on torch 2.11 while its all-reduce runs."""
    import torch.distributed as dist

    return mesh.device_type == "cuda" and dist.get_backend(mesh.get_group(0)) == "gloo"


class _GatherByAllReduce(torch.autograd.Function):
    """A DTensor's shards on mesh dims ``dims`` gathered: each rank's shard
    written into zeros at its offset, then summed over the dim's ranks
    (exact: every other summand is zero, but for a ``-0.0``, which comes
    back ``+0.0``).  The backward lays the gradient out as the input was
    (a local slice, or a reduce-scatter of partial sums)."""

    @staticmethod
    def forward(ctx, x, dims):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        mesh = x.device_mesh
        ctx.placements = tuple(x.placements)
        local = x.to_local()
        pl = list(x.placements)
        for i in dims:
            d, n = pl[i].dim, mesh.size(i)
            rank = mesh.get_local_rank(i)
            before, after = list(local.shape), list(local.shape)
            before[d], after[d] = rank * local.shape[d], (n - 1 - rank) * local.shape[d]
            local = torch.cat([local.new_zeros(before), local, local.new_zeros(after)], dim=d)
            pl[i] = Partial()
        out = DTensor.from_local(local, mesh, tuple(pl), run_check=False)
        return out.redistribute(mesh, tuple(Replicate() if i in dims else p
                                            for i, p in enumerate(pl)))

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


class _ReducePartial(torch.autograd.Function):
    """A DTensor's partial sums on mesh dims ``dims`` reduced (an
    all-reduce).  The backward hands the gradient back replicated on those
    dims, the whole gradient each summand receives; DTensor's own backward
    would mark it ``Partial``, and a row-parallel product's weight
    gradient would then all-gather its other operand."""

    @staticmethod
    def forward(ctx, x, dims):
        from torch.distributed.tensor import Replicate

        ctx.dims = dims
        return x.redistribute(x.device_mesh, tuple(
            Replicate() if i in dims else p for i, p in enumerate(x.placements)))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate

        return redistribute(grad, tuple(Replicate() if i in ctx.dims else p
                                        for i, p in enumerate(grad.placements))), None


class _Slice(torch.autograd.Function):
    """A DTensor's replicated dims ``dims`` sharded as ``placements`` (a
    local slice, nothing sent) on a mesh that gathers by all-reduce: its
    backward gathers the gradient through :func:`redistribute`, where
    DTensor's own would call the functional all-gather."""

    @staticmethod
    def forward(ctx, x, placements, dims):
        ctx.placements = tuple(x.placements)
        ctx.dims = dims
        return x.redistribute(x.device_mesh, tuple(
            placements[i] if i in dims else p for i, p in enumerate(x.placements)))

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, tuple(ctx.placements[i] if i in ctx.dims else p
                                        for i, p in enumerate(grad.placements))), None, None


def redistribute(x, placements, mesh=None):
    """``x`` (a DTensor, or a plain tensor standing for a replicated value
    on ``mesh``) laid out as ``placements``."""
    if not is_dtensor(x):
        x = replicate(x, mesh)
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    mesh = x.device_mesh
    reduce = tuple(i for i, (a, b) in enumerate(zip(x.placements, placements))
                   if a.is_partial() and b.is_replicate() and mesh.size(i) > 1)
    if reduce:
        x = _ReducePartial.apply(x, reduce)
    if _gathers_by_all_reduce(mesh):
        gather = [i for i, (a, b) in enumerate(zip(x.placements, placements))
                  if a.is_shard() and b.is_replicate() and mesh.size(i) > 1]
        sharded = [p.dim for p in x.placements if p.is_shard()]
        # a tensor dim sharded over two mesh dims is left to DTensor
        if gather and all(sharded.count(x.placements[i].dim) == 1
                          and x.shape[x.placements[i].dim] % mesh.size(i) == 0
                          for i in gather):
            x = _GatherByAllReduce.apply(x, tuple(gather))
        slices = tuple(i for i, (a, b) in enumerate(zip(x.placements, placements))
                       if a.is_replicate() and b.is_shard() and mesh.size(i) > 1)
        if slices:
            x = _Slice.apply(x, placements, slices)
    return x.redistribute(mesh, placements)


def local_shard(full_tensor: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full_tensor`` under ``placements`` (mesh dims
    in order, ``torch.chunk``'s blocks, as DTensor lays them out); a slice,
    nothing is sent."""
    out = full_tensor
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            out = torch.chunk(out, mesh.size(i), dim=p.dim)[coord[i]]
    return out


def placements_of(x, mesh) -> tuple:
    """``x``'s placements, or all ``Replicate()`` for a plain tensor."""
    from torch.distributed.tensor import Replicate

    return tuple(x.placements) if is_dtensor(x) else (Replicate(),) * mesh.ndim


def replicated_partials(x):
    """A DTensor with its partial sums (or means) reduced, its shards kept."""
    from torch.distributed.tensor import Replicate

    return redistribute(x, tuple(Replicate() if p.is_partial() else p for p in x.placements))


def replicated(x):
    """A DTensor laid out ``Replicate()`` on every mesh dim (its partial
    sums reduced, its shards gathered); anything else unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return redistribute(x, (Replicate(),) * x.device_mesh.ndim)


def block_of(x, dim: int):
    """(start, size) of this rank's block of a DTensor's tensor dim
    ``dim`` (the whole dim where no mesh dim shards it)."""
    mesh, start, size = x.device_mesh, 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim:
            size //= mesh.size(i)
            start += mesh.get_local_rank(i) * size
    return start, size


def full(x):
    """The whole value of ``x`` as a plain tensor: a DTensor's gathered and
    reduced (a collective every rank of its mesh joins), ``x`` itself
    otherwise."""
    return replicated(x).to_local() if is_dtensor(x) else x


def local_map(fn: Callable, mesh, args: Sequence, in_placements: Sequence,
              out_placements):
    """``fn`` on each rank's local shards.

    ``args[i]`` is redistributed to ``in_placements[i]`` and passed as its
    local tensor; an entry ``None`` passes ``args[i]`` through unchanged
    (a Python value, or a tensor that is already this rank's own).
    ``out_placements`` is the placements of ``fn``'s result, or a tuple of
    them (``None`` entries: returned as the local tensor) for a tuple of
    results.  An input's gradient is ``Partial`` on each mesh dim where it
    is replicated and an output is sharded or partial."""
    from torch.distributed.tensor import DTensor, Partial

    many = isinstance(out_placements, list)
    outs = out_placements if many else [out_placements]
    split = [any(o is not None and not o[i].is_replicate() for o in outs)
             for i in range(mesh.ndim)]
    local = []
    for a, pl in zip(args, in_placements):
        if pl is None:
            local.append(a)
            continue
        d = redistribute(a, pl, mesh)
        grad = tuple(Partial() if p.is_replicate() and split[i] else p
                     for i, p in enumerate(pl))
        local.append(d.to_local(grad_placements=grad))
    res = fn(*local)
    res_list = list(res) if many else [res]
    wrapped = [r if pl is None else
               _GradAs.apply(DTensor.from_local(r, mesh, pl, run_check=False))
               for r, pl in zip(res_list, outs)]
    return wrapped if many else wrapped[0]


class _GradAs(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as its input
    (replicated where the input is partial, as ``from_local`` takes it)
    through :func:`redistribute`: ``from_local``'s own backward would
    gather a sharded gradient with DTensor's all-gather."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, ctx.placements)


def _reshaped(x, shape, dim: int, n: int):
    """``x.reshape(shape)``, where the reshape splits or merges ``x``'s dim
    ``dim`` with ``n`` heads.  On a DTensor, a mesh dim that cannot split
    the heads evenly holds ``dim`` replicated, and the gradient is laid out
    so before the backward reshapes it back: DTensor cannot flatten or
    unflatten an uneven shard (24 SSM heads, or 40 query heads, on a model
    axis of 16)."""
    if not is_dtensor(x):
        return x.reshape(shape)
    mesh = x.device_mesh
    uneven = [i for i in range(mesh.ndim) if n % mesh.size(i)]
    if not uneven:
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate

    x = redistribute(x, tuple(Replicate() if i in uneven and p.is_shard() and p.dim == dim
                              else p for i, p in enumerate(x.placements)))
    return _GradAs.apply(x.reshape(shape))


def split_last(x, n: int):
    """``(..., n * d) -> (..., n, d)``; on a DTensor, as :func:`_reshaped`
    lays it out (an even shard of the last dim stays on the heads)."""
    return _reshaped(x, (*x.shape[:-1], n, x.shape[-1] // n), x.dim() - 1, n)


def merge_last(x):
    """``(..., n, d) -> (..., n * d)``; on a DTensor, as :func:`_reshaped`
    lays it out."""
    return _reshaped(x, (*x.shape[:-2], x.shape[-2] * x.shape[-1]), x.dim() - 2, x.shape[-2])


def heads_layout(mesh, lead, heads_dim: int) -> tuple:
    """Placements a per-head kernel can run under: ``lead``'s sharding of
    its batch dim (0), and of its heads dim where the mesh dim divides
    ``lead``'s head count; replicated elsewhere (a sequence or partial
    layout is gathered or reduced: the kernels need every position)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for i, p in enumerate(placements_of(lead, mesh)):
        if p.is_shard() and p.dim == 0:
            out.append(Shard(0))
        elif p.is_shard() and p.dim == heads_dim and lead.shape[heads_dim] % mesh.size(i) == 0:
            out.append(Shard(heads_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def gqa_map(fn: Callable, mesh, q, k, v):
    """``fn(q, k, v)``, attention of plain tensors with grouped KV heads (q
    ``(B, Hq, ...)``, k and v ``(B, Hk, ...)``, query head ``h`` reading KV
    head ``h // (Hq / Hk)``), on each rank's shards; the output is laid out
    as ``q``.

    The batch is sharded as ``q`` shards it.  On a mesh dim that shards
    ``q``'s heads: where it divides both counts, both are sharded (each rank
    keeps ``Hq/n`` query and ``Hk/n`` KV heads); where it divides only the
    query heads and each rank's query heads fall in one KV group (and no
    other mesh dim shards heads), ``q`` keeps its heads shard and K and V
    come whole on that dim, each rank handing ``fn`` the KV head of its
    group.  Their gradients then come back as partial sums over the ranks
    (zero outside each rank's head), which the layout of K and V reduces.
    Elsewhere everything is replicated (a sequence or partial layout is
    gathered or reduced: attention needs every position)."""
    from torch.distributed.tensor import Replicate, Shard

    hq, hk = q.shape[1], k.shape[1]
    group = hq // hk
    pq, pkv, grouped = [], [], []
    for i, p in enumerate(placements_of(q, mesh)):
        n = mesh.size(i)
        if p.is_shard() and p.dim == 0:
            pq.append(Shard(0))
            pkv.append(Shard(0))
        elif p.is_shard() and p.dim == 1 and hq % n == 0 and hk % n == 0:
            pq.append(Shard(1))
            pkv.append(Shard(1))
        elif p.is_shard() and p.dim == 1 and hq % n == 0 and group % (hq // n) == 0:
            pq.append(Shard(1))
            pkv.append(Replicate())
            grouped.append(i)
        else:
            pq.append(Replicate())
            pkv.append(Replicate())
    heads = [i for i, p in enumerate(pq) if p.is_shard() and p.dim == 1]
    if grouped and len(heads) > 1:
        for i in grouped:
            pq[i] = Replicate()
        grouped = []
    pq, pkv = tuple(pq), tuple(pkv)
    if not grouped:
        return local_map(fn, mesh, (q, k, v), (pq, pkv, pkv), pq)
    n = mesh.size(grouped[0])
    j = mesh.get_local_rank(grouped[0]) * (hq // n) // group
    return local_map(lambda a, b, c: fn(a, b[:, j:j + 1], c[:, j:j + 1]), mesh, (q, k, v),
                     (pq, pkv, pkv), pq)


def batch_like(x, ref):
    """``x`` (a DTensor; anything else is returned as it is) with its batch
    dim (0) laid out as ``ref``'s: sharded on each mesh dim where ``ref``
    shards dim 0 (partial sums reduce-scattered onto it), ``x``'s other
    shards kept, and replicated elsewhere."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    out = tuple(Shard(0) if r.is_shard() and r.dim == 0 else
                p if p.is_shard() and p.dim != 0 else Replicate()
                for p, r in zip(x.placements, placements_of(ref, x.device_mesh)))
    return redistribute(x, out)


def moved(placements, dims: dict) -> tuple:
    """``placements`` with each ``Shard(a)`` renumbered ``Shard(dims[a])``,
    or replicated when ``a`` is not in ``dims`` (the same sharding of a
    tensor whose dims are laid out differently)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims else Replicate()
                 for p in placements)
