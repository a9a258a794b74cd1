"""Atomic checkpoints in the reference's on-disk layout (port of
``repro.train.checkpoint``), with elastic restore onto another mesh.

Layout::

    <dir>/step_000123/
        manifest.json          # step, leaf names, shapes and dtypes, extra
        host_0.npz             # every leaf, named as in the manifest

* **Atomic**: written to ``step_X.tmp0`` and then renamed, so a crash never
  leaves a half-checkpoint that :func:`latest_step` would pick up.
* **The reference's names**: a leaf is named by its path as
  ``jax.tree_util.tree_flatten_with_path`` prints it (``[0]``, ``['key']``,
  ``.field`` joined by ``/``), so a checkpoint written by either package
  restores in the other.  An ``nn.Module`` is the dict of its children and
  parameters (a module whose only child is an ``nn.ModuleList``, such as
  :class:`~repro_torch.nsde.MLP`, is that list), and an optimizer state's
  per-parameter lists, which the port keeps in ``parameters()`` order, take
  the names of the module's parameters beside it: the reference's optimizer
  state mirrors its parameter dict.
* **bf16** is stored as its uint16 bits (npz has no bf16).
* **Restore writes in place**: every tensor leaf of ``like`` receives the
  saved values with ``copy_``, so a rollback never re-points the static
  inputs of a captured CUDA graph (or the parameters of a module).
* **DTensor leaves** are written whole: every rank joins the gather of
  each one, global rank 0 writes the files, and the ranks meet at a
  barrier before :func:`save_checkpoint` returns.  A checkpoint of sharded
  leaves restores in either package, onto any mesh: ``shardings`` lays
  each leaf out anew (elastic restore), every rank keeping its shard of
  the saved values.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..optim.optimizers import OptState
from ..spmd import full, is_dtensor, local_shard

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "checkpoint_meta"]

HOST = 0  # the writing process (global rank 0 under a mesh); the reference's jax.process_index()


def _module_entries(module: nn.Module, prefix: str, out: List[Tuple[str, Any]]):
    children = dict(module.named_children())
    params = dict(module.named_parameters(recurse=False))
    if isinstance(module, nn.ModuleList):
        for i, child in enumerate(module):
            _module_entries(child, f"{prefix}[{i}]/", out)
        return
    if not params and len(children) == 1 and isinstance(
            next(iter(children.values())), nn.ModuleList):
        _module_entries(next(iter(children.values())), prefix, out)
        return
    named = [(k, v) for k, v in params.items()] + list(children.items())
    for key, value in sorted(named, key=lambda kv: kv[0]):
        if isinstance(value, nn.Module):
            _module_entries(value, f"{prefix}['{key}']/", out)
        else:
            out.append((f"{prefix}['{key}']", value))


def _entries(tree, prefix: str, out: List[Tuple[str, Any]], param_names=None):
    """``(name, leaf)`` pairs of ``tree`` in the reference's path syntax."""
    if tree is None:
        return
    if isinstance(tree, nn.Module):
        _module_entries(tree, prefix, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _entries(tree[k], f"{prefix}['{k}']/", out)
    elif isinstance(tree, OptState):
        for field in tree._fields:
            value = getattr(tree, field)
            if (param_names is not None and isinstance(value, (list, tuple))
                    and len(value) == len(param_names)):
                for name, leaf in zip(param_names, value):
                    out.append((f"{prefix}.{field}/{name}", leaf))
            else:
                _entries(value, f"{prefix}.{field}/", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            _entries(getattr(tree, field), f"{prefix}.{field}/", out)
    elif isinstance(tree, (list, tuple)):
        # The names of a module's parameters in parameters() order, for an
        # optimizer state beside it.
        names = None
        for item in tree:
            if isinstance(item, nn.Module):
                found: List[Tuple[str, Any]] = []
                _module_entries(item, "", found)
                order = {id(p): n for n, p in found}
                names = [order[id(p)] for p in item.parameters()]
        for i, item in enumerate(tree):
            _entries(item, f"{prefix}[{i}]/", out, names)
    else:
        out.append((prefix[:-1] if prefix.endswith("/") else prefix, tree))


def _named_leaves(tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    _entries(tree, "", out)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).cpu().numpy().view(np.uint16)
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Write ``tree`` atomically under ``directory/step_<step>``.

    ``extra``: JSON-serialisable metadata stored in the manifest (the
    chunked train loops record their ``steps_per_call``; any
    ``steps_per_call`` may resume any checkpoint, scanned chunks being
    bitwise the sequential steps)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{HOST}"
    arrays = {}
    meta = {"step": step, "leaves": []}
    if extra:
        meta["extra"] = dict(extra)
    named = _named_leaves(tree)
    sharded, writer = any(is_dtensor(leaf) for _, leaf in named), True
    if sharded:
        import torch.distributed as dist

        writer = dist.get_rank() == HOST
    for name, leaf in named:
        if is_dtensor(leaf):
            leaf = full(leaf.detach())  # every rank joins the gather
        if not writer:
            continue
        arr = _to_numpy(leaf)
        arrays[name] = arr
        meta["leaves"].append({"name": name, "shape": list(arr.shape),
                               "dtype": _dtype_name(leaf)})
    if sharded:
        if not writer:
            dist.barrier()
            return final
        try:
            _write(tmp, final, arrays, meta)
        finally:
            dist.barrier()
        return final
    _write(tmp, final, arrays, meta)
    return final


def _write(tmp: str, final: str, arrays: dict, meta: dict) -> None:
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"host_{HOST}.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, final)


def checkpoint_meta(directory: str, step: int) -> dict:
    """The ``extra`` metadata recorded with a checkpoint ({} when none)."""
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f).get("extra", {})


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(f".tmp{HOST}")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any, shardings=None) -> Any:
    """Restore the checkpoint into ``like``, a tree of tensors (an
    ``nn.Module``, an optimizer state, or tuples and dicts of them): every
    leaf is overwritten in place with ``copy_`` (converted to its dtype; a
    DTensor leaf receives its shard), and ``like`` itself is returned.

    ``shardings`` (the reference's, for elastic restore onto a new mesh):
    a tree of :class:`~repro_torch.launch.mesh.Sharding` as
    :func:`~repro_torch.launch.mesh.place` takes it; each leaf is laid out
    by its sharding and holds the saved values (a leaf already laid out so
    is written in place), and the restored tree is returned."""
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, f"host_{HOST}.npz")) as z:
        data = {k: z[k] for k in z.files}
    named = _named_leaves(like)
    for name, leaf in named:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"restore_checkpoint writes into tensors; leaf "
                            f"{name} is a {type(leaf).__name__}")
        if name not in data:
            raise KeyError(f"checkpoint {path} has no leaf {name}")
    values = {}
    for name, leaf in named:
        arr = data[name]
        if leaf.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            src = torch.from_numpy(np.ascontiguousarray(arr))
        values[id(leaf)] = src.reshape(leaf.shape)
    if shardings is not None:
        from ..launch.mesh import place

        return place(like, shardings, values=values)
    with torch.no_grad():
        for name, leaf in named:
            if is_dtensor(leaf):
                leaf.to_local().copy_(local_shard(values[id(leaf)], leaf.device_mesh,
                                                  leaf.placements))
            else:
                leaf.copy_(values[id(leaf)])
    return like
