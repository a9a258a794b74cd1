"""Device meshes and sharding rules on ``torch.distributed`` (port of
``repro.launch.mesh``).

Torch runs one process per card (SPMD: every rank runs the same program on
its share of the data), so a mesh here is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of a
process group the caller has initialised (``init_process_group`` with its
address, world size and rank; nothing here starts one).  The sampling and
training meshes are 1-D: ``"mc"`` shards the Monte-Carlo path axis of
``sdeint`` and the serving engine's slots, ``"dp"`` the trainer's paths.

The sharding rules are the reference's, rule for rule, over parameter
paths (see its module doc: vocab-parallel embeddings, head-parallel
attention, megatron MLPs, expert parallelism, the Mamba projections, the
divisibility guard that falls back to replication).  They read only the
mesh's axis sizes, so any object whose ``shape`` is a mapping of axis name
to size drives them, as does a ``DeviceMesh`` (``shape`` with
``mesh_dim_names``).  A spec is a :class:`PartitionSpec`: a tuple with one
entry per tensor dim, each ``None``, an axis name or a tuple of axis
names, equal to the reference's ``PartitionSpec`` entries.
:func:`shardings_for` turns specs into DTensor placements.

:func:`place` is the reference's ``jax.device_put(params,
shardings_for(mesh, param_pspecs(...)))``: it turns an
:class:`~repro_torch.models.LMParams` (in place: its parameters become
``nn.Parameter``s wrapping DTensors) and an optimizer state into DTensors
laid out by :func:`param_shardings` / :func:`opt_state_shardings`, each
rank keeping its shard of the full values it holds (nothing is sent).
:func:`gather_full` is the inverse.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from ..optim.optimizers import OptState
from ..spmd import full, is_dtensor, local_shard, placements_for, redistribute

__all__ = [
    "make_production_mesh",
    "make_sample_mesh",
    "make_train_mesh",
    "axis_size",
    "param_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "shardings_for",
    "opt_state_pspecs",
    "batch_axes",
    "PartitionSpec",
    "abstract_param_tree",
    "ambient_mesh",
    "AxisBlock",
    "axis_block",
    "gather_blocks",
    "graph_capturable",
    "Sharding",
    "param_shardings",
    "opt_state_shardings",
    "cache_shardings",
    "place",
    "gather_full",
]


def _normal_entry(entry):
    """The reference's normal form: a list is a tuple, a tuple of one axis
    is that axis, an empty tuple is ``None``."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of two or more axis names, normalised as the reference's
    ``PartitionSpec`` is.  A tuple, so it compares equal to the plain tuple
    of its entries; its own type marks it as a leaf in spec trees."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_normal_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# Meshes.
# ---------------------------------------------------------------------------

def _world_size() -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "(backend, init_method='tcp://<host>:<port>', world_size, rank) "
            "on every rank first; a single process is a world of one")
    return dist.get_world_size()


def _device_mesh(device, shape, axes):
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device.type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``.  The
    world must hold exactly that many ranks (``ValueError`` otherwise)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs "
            f"{math.prod(shape)} ranks; the world has {world}")
    return _device_mesh(device, shape, axes)


def make_sample_mesh(n_devices: Optional[int] = None, axis: str = "mc", *,
                     device=None):
    """1-D Monte-Carlo sampling mesh over the first ``n_devices`` ranks of
    the world (default: all of them) on one axis named ``axis``.

    ``device`` (default ``"cuda"``) is the mesh's device type: ``"cuda"``
    with NCCL, ``"cpu"`` with gloo.  Every rank of the world calls this
    (a sub-mesh is a new process group); a rank outside the first
    ``n_devices`` holds no block of a sharded batch."""
    world = _world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(
            f"n_devices={n_devices} not in [1, {world}] ranks of the world")
    return _device_mesh(device, (n,), (axis,))


def make_train_mesh(n_devices: Optional[int] = None, axis: str = "dp", *,
                    device=None):
    """1-D data-parallel training mesh: :func:`make_sample_mesh` with the
    axis named ``"dp"``; the trainer shards the Monte-Carlo *path* axis.
    Feed it to ``make_sde_train_step(..., mesh=make_train_mesh(),
    mesh_axis="dp")``."""
    return make_sample_mesh(n_devices, axis=axis, device=device)


def ambient_mesh():
    """The mesh of the innermost ``with mesh:`` block (a ``DeviceMesh`` is
    a context manager); ``ValueError`` outside one."""
    from torch.distributed import device_mesh

    stack = getattr(getattr(device_mesh, "_mesh_resources", None), "mesh_stack", None)
    if not stack:
        raise ValueError(
            "mesh_axis given but no mesh: pass mesh=... or call inside "
            "`with mesh:` (see repro_torch.launch.mesh.make_sample_mesh)")
    return stack[-1]


class AxisBlock(NamedTuple):
    """This rank's place on one mesh axis: ``world`` ranks on the axis,
    this one at ``rank``, their process ``group``."""

    world: int
    rank: int
    group: Any

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows."""
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)


def axis_block(mesh, axis: str) -> AxisBlock:
    """This rank's :class:`AxisBlock` on ``mesh``'s axis ``axis``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (its axes: {names})")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh: it holds no block of a "
                         "sharded batch")
    return AxisBlock(int(mesh.size(names.index(axis))), int(mesh.get_local_rank(axis)),
                     mesh.get_group(axis))


def gather_blocks(x: torch.Tensor, block: AxisBlock, dim: int = 0) -> torch.Tensor:
    """Every rank's block of ``x`` concatenated in rank order along ``dim``,
    by an all-gather (exact: nothing is summed)."""
    import torch.distributed as dist

    src = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((block.world * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=block.group)
    return out.movedim(0, dim).contiguous()


def graph_capturable(mesh) -> bool:
    """Whether collectives over ``mesh``'s process groups can be captured
    into a CUDA graph: NCCL's run on the device and can; gloo's stage CUDA
    tensors through the host and cannot."""
    import torch.distributed as dist

    return all(dist.get_backend(g) == "nccl" for g in mesh.get_all_groups())


def _sizes(mesh) -> Mapping[str, int]:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return shape
    return dict(zip(mesh.mesh_dim_names, shape))


def axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(axis, (tuple, list)):
        return int(math.prod(sizes[a] for a in axis))
    return int(sizes[axis])


def _safe(mesh, shape, spec_entries) -> PartitionSpec:
    """Drop shardings whose axis size does not divide the dim."""
    out = []
    for dim, entry in zip(shape, spec_entries):
        if entry is None or dim % axis_size(mesh, entry) != 0:
            out.append(None)
        else:
            out.append(entry)
    return P(*out)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts (sorted keys), namedtuples,
    lists and tuples whose leaves have a ``shape``; ``None`` stays."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and a tree of the same structure."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, tree)
    if specs is None:
        return None
    if isinstance(specs, Mapping):
        return {k: _map_specs(fn, specs[k], tree[k]) for k in specs}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_map_specs(fn, s, t) for s, t in zip(specs, tree)))
    return type(specs)(_map_specs(fn, s, t) for s, t in zip(specs, tree))


# ---------------------------------------------------------------------------
# Parameter sharding.
# ---------------------------------------------------------------------------

_COL = {"wq", "wk", "wv", "wg", "wu", "wz", "wx", "wB", "wC", "wdt", "conv_x",
        "conv_B", "conv_C"}
_ROW = {"wo", "wd", "out_proj"}
_HEADVEC = {"bq", "bk", "bv", "conv_bx", "conv_bB", "conv_bC", "A_log", "D",
            "dt_bias", "gate_norm"}


def _leaf_spec(mesh, name: str, shape, *, fsdp: Optional[str], stacked: bool):
    eff = shape[1:] if stacked else shape
    model = "model"

    def done(entries):
        if stacked:
            entries = (None,) + tuple(entries)
        return _safe(mesh, shape, entries)

    if name == "embed":
        return _safe(mesh, shape, (model, fsdp))
    if name == "lm_head":
        return _safe(mesh, shape, (fsdp, model))
    if name in ("vision_proj", "frame_proj"):
        return _safe(mesh, shape, (None, model))
    if name == "router":
        return done((None,) * len(eff))
    if name in _COL:
        if len(eff) == 3:  # MoE expert-stacked (E, d, f): EP on experts
            return done((model, fsdp, None))
        return done((fsdp, model))
    if name in _ROW:
        if len(eff) == 3:  # (E, f, d)
            return done((model, None, fsdp))
        return done((model, fsdp))
    if name in _HEADVEC:
        return done((model,) + (None,) * (len(eff) - 1))
    # norms and anything unrecognised: replicate
    return done((None,) * len(eff))


def param_pspecs(mesh, abstract_params, *, fsdp: bool = False):
    """A tree of :class:`PartitionSpec` matching ``abstract_params`` (the
    reference's parameter layout, per-layer leaves stacked on a leading
    axis under ``"layers"``: see :func:`abstract_param_tree`)."""
    fsdp_axis = "data" if fsdp else None

    def assign(path, leaf):
        return _leaf_spec(mesh, path[-1], tuple(leaf.shape), fsdp=fsdp_axis,
                          stacked="layers" in path)

    return _map_with_path(assign, abstract_params)


def opt_state_pspecs(mesh, abstract_opt_state, pspecs_params, *, zero1: bool = False):
    """``OptState(step, mu, nu)`` sharded like the parameters.

    ``zero1``: additionally shard each moment's first replicated dim that
    the ``"data"`` axis divides (ZeRO-1) — the parameters stay replicated
    across ``"data"``; only the updated ones are gathered once a step."""
    if not zero1:
        return OptState(step=P(), mu=pspecs_params, nu=pspecs_params)
    mu = _map_specs(lambda spec, leaf: _zero1(mesh, spec, tuple(leaf.shape)),
                    pspecs_params, abstract_opt_state.mu)
    return OptState(step=P(), mu=mu, nu=mu)


def _zero1(mesh, spec, shape) -> PartitionSpec:
    """``spec`` with its first replicated dim that ``"data"`` divides (and
    longer than 1) sharded on ``"data"``."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % axis_size(mesh, "data") == 0 and dim > 1:
            entries[i] = "data"
            break
    return _safe(mesh, shape, entries)


def abstract_param_tree(params) -> dict:
    """An :class:`~repro_torch.models.LMParams` in the reference's layout,
    as meta tensors: ``embed``, ``layers`` (each group's leaves stacked on a
    leading layer axis), ``shared`` and the optional top-level leaves —
    the tree :func:`param_pspecs` takes."""
    def meta(shape):
        return torch.empty(tuple(shape), device="meta")

    tree = {"embed": meta(params.embed.shape)}
    layers = list(params.layers)
    tree["layers"] = {
        group: {name: meta((len(layers),) + tuple(p.shape))
                for name, p in sub.items()}
        for group, sub in layers[0].items()}
    shared = params.get("shared")
    if shared is not None:
        tree["shared"] = {group: {name: meta(p.shape) for name, p in sub.items()}
                          for group, sub in shared.items()}
    for name in ("final_norm", "lm_head", "vision_proj", "frame_proj"):
        leaf = params.get(name)
        if leaf is not None:
            tree[name] = meta(leaf.shape)
    return tree


# ---------------------------------------------------------------------------
# Batch / cache sharding.
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _sizes(mesh))


def batch_pspecs(mesh, abstract_batch, *, seq_shard: bool = False):
    """tokens/labels ``(B, S, ...)``: batch on (pod, data); optionally the
    sequence on them instead (sequence parallelism)."""
    ba = batch_axes(mesh)

    def assign(path, leaf):
        dims = len(leaf.shape)
        if seq_shard and dims >= 2:
            entries = (None, ba) + (None,) * (dims - 2)
        else:
            entries = (ba,) + (None,) * (dims - 1)
        return _safe(mesh, tuple(leaf.shape), entries)

    return _map_with_path(assign, abstract_batch)


def cache_pspecs(mesh, abstract_cache, *, batch: int):
    """Decode caches: batch-shard when divisible, else shard heads/state on
    ``"model"`` and sequence on data (the long-context layout)."""
    ba = batch_axes(mesh)
    batch_ok = batch % axis_size(mesh, ba) == 0 and batch > 1

    def assign(path, leaf):
        name = path[-1] if path else ""
        shape = tuple(leaf.shape)
        if name in ("k", "v", "shared_k", "shared_v"):
            # (L|inv, B, KV, S, hd): batch on data; heads on model when they
            # divide, otherwise sequence on model
            if batch_ok:
                spec = _safe(mesh, shape, (None, ba, "model", None, None))
                if spec[2] is None:
                    spec = _safe(mesh, shape, (None, ba, None, "model", None))
                return spec
            spec = _safe(mesh, shape, (None, None, "model", ba, None))
            if spec[2] is None:
                return _safe(mesh, shape, (None, None, None, ba + ("model",), None))
            return spec
        if name == "state":  # (L, B, nh, dh, ds)
            if batch_ok:
                return _safe(mesh, shape, (None, ba, "model", None, None))
            spec = _safe(mesh, shape, (None, None, "model", None, None))
            if spec[2] is None:  # nh not divisible: shard the state dim
                spec = _safe(mesh, shape, (None, None, None, None, "model"))
            return spec
        if name.startswith("conv_"):  # (L, B, K-1, di|ds)
            if batch_ok:
                return _safe(mesh, shape, (None, ba, None, "model"))
            return _safe(mesh, shape, (None, None, None, "model"))
        return P(*([None] * len(shape)))

    return _map_with_path(assign, abstract_cache)


def shardings_for(mesh, pspecs):
    """Each spec as DTensor placements on ``mesh`` (a ``DeviceMesh``): per
    mesh dim, ``Shard(i)`` for the tensor dim ``i`` whose entry names that
    axis, else ``Replicate()``.  A tree of placement tuples."""
    return _map_specs(lambda spec, _leaf=None: placements_for(mesh, spec), pspecs, pspecs)


# ---------------------------------------------------------------------------
# Placing parameters and optimizer states.
# ---------------------------------------------------------------------------

class Sharding(NamedTuple):
    """A DTensor layout: ``placements`` on ``mesh`` (the reference's
    ``NamedSharding``)."""

    mesh: Any
    placements: tuple


def _param_specs(mesh, params, fsdp: bool) -> dict:
    """``{name: spec}`` for each of ``params.named_parameters()`` by
    :func:`param_pspecs`'s rules on the reference layout (a layer's spec is
    its stacked leaf's without the layer axis)."""
    specs = param_pspecs(mesh, abstract_param_tree(params), fsdp=fsdp)
    out = {}
    for name, _ in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            out[name] = P(*specs["layers"][parts[2]][parts[3]][1:])
        elif parts[0] == "shared":
            out[name] = specs["shared"][parts[1]][parts[2]]
        else:
            out[name] = specs[parts[0]]
    return out


def param_shardings(mesh, params, *, fsdp: bool = False) -> dict:
    """``{name: Sharding}`` for each of ``params.named_parameters()`` (an
    :class:`~repro_torch.models.LMParams`), by :func:`param_pspecs`'s
    rules."""
    return {name: Sharding(mesh, placements_for(mesh, spec))
            for name, spec in _param_specs(mesh, params, fsdp).items()}


def opt_state_shardings(mesh, params, *, fsdp: bool = False,
                        zero1: bool = False) -> OptState:
    """``OptState(step=None, mu=[Sharding], nu=[Sharding])`` for an
    optimizer state of ``list(params.parameters())``, by
    :func:`opt_state_pspecs`'s rules (``zero1``: each moment's first
    replicated dim that ``"data"`` divides sharded on it, a layer's own
    dims, as the port keeps its layers apart); the step stays as it is,
    the same scalar on every rank."""
    specs = _param_specs(mesh, params, fsdp)
    mu = [Sharding(mesh, placements_for(
        mesh, _zero1(mesh, specs[name], tuple(p.shape)) if zero1 else specs[name]))
        for name, p in params.named_parameters()]
    return OptState(step=None, mu=mu, nu=list(mu))


def cache_shardings(mesh, cache, *, batch: int):
    """A decode cache's layout by :func:`cache_pspecs`: the stacked leaves'
    :class:`Sharding` tree (for :func:`place`) and the per-layer specs by
    leaf name (for ``ModelOptions(cache_constraints=...)``; the shared
    attention's caches go by ``"k"`` and ``"v"``, as the reference's)."""
    specs = cache_pspecs(mesh, cache, batch=batch)
    shardings = _map_specs(lambda spec, _: Sharding(mesh, placements_for(mesh, spec)),
                           specs, specs)
    flat = dict(specs.get("mamba", {}))
    for key in ("k", "v", "shared_k", "shared_v"):
        if key in specs:
            flat[key[-1]] = specs[key]
    return shardings, {name: P(*spec[1:]) for name, spec in flat.items()}


def _placed(leaf, sharding, value=None):
    """``leaf`` laid out by ``sharding`` (None: as it is), holding ``value``
    (a full tensor) or its own values.  A DTensor already laid out so is
    written in place and returned."""
    from torch.distributed.tensor import DTensor

    if sharding is None:
        if value is not None:
            with torch.no_grad():
                if is_dtensor(leaf):
                    leaf.to_local().copy_(local_shard(value, leaf.device_mesh,
                                                      leaf.placements))
                else:
                    leaf.copy_(value)
        return leaf
    mesh, pl = sharding
    if is_dtensor(leaf) and leaf.device_mesh == mesh:
        if tuple(leaf.placements) == tuple(pl):
            return _placed(leaf, None, value)
        if value is None:  # DTensor's own collective between the layouts
            return redistribute(leaf, pl)
    if value is None:
        value = full(leaf.detach())
    value = value.to(device=leaf.device, dtype=leaf.dtype)
    return DTensor.from_local(local_shard(value, mesh, pl).clone(), mesh, pl,
                              run_check=False)


def _set_param(module, name: str, tensor):
    owner, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner) if owner else module
    old = getattr(owner, leaf)
    setattr(owner, leaf, torch.nn.Parameter(tensor, requires_grad=old.requires_grad))


def place(tree, shardings, *, values=None):
    """``tree`` laid out by ``shardings``: an ``nn.Module`` with a dict
    ``{parameter name: Sharding}`` (its parameters replaced in place by
    ``nn.Parameter``s wrapping DTensors, the module returned), an
    :class:`OptState` with an ``OptState`` of shardings, a dict, list or
    tuple with one of the same structure, a tensor with a
    :class:`Sharding` (None: left as it is).  Each rank keeps its shard of the full values it holds;
    a DTensor leaf is redistributed on its own mesh, gathered first onto
    another.
    ``values`` (``{id(leaf): full tensor}``) gives a leaf other values, as
    a checkpoint restore does; a leaf already laid out so is written in
    place."""
    values = values or {}
    if isinstance(tree, torch.nn.Module):
        shardings = shardings or {}
        for name, p in list(tree.named_parameters()):
            new = _placed(p, shardings.get(name), values.get(id(p)))
            if new is not p:
                _set_param(tree, name, new)
        return tree
    if isinstance(tree, OptState):
        shardings = shardings or OptState(None, None, None)
        return OptState(*(place(t, s, values=values) for t, s in zip(tree, shardings)))
    if isinstance(tree, dict):
        shardings = shardings or {}
        return {k: place(v, shardings.get(k), values=values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        shardings = [None] * len(tree) if shardings is None else shardings
        return type(tree)(place(t, s, values=values) for t, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        return _placed(tree, shardings, values.get(id(tree)))
    return tree


def gather_full(tree):
    """The inverse of :func:`place`: every DTensor of ``tree`` as its full
    tensor on every rank (a collective each rank of its mesh joins); a
    module's parameters are replaced in place."""
    if isinstance(tree, torch.nn.Module):
        for name, p in list(tree.named_parameters()):
            if is_dtensor(p):
                _set_param(tree, name, full(p.detach()))
        return tree
    if isinstance(tree, OptState):
        return OptState(*(gather_full(t) for t in tree))
    if isinstance(tree, dict):
        return {k: gather_full(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_full(t) for t in tree)
    return full(tree) if isinstance(tree, torch.Tensor) else tree
