"""Pytrees of tensors and the leafwise linear algebra of the solve stack.

Port of ``repro.core.pytree``.  A state is a tensor or a nested tuple, list,
dict or namedtuple of tensors (product-group states are tuples); ``None`` is
an empty subtree, as in jax.  The flatten/unflatten pair here replaces
``jax.tree_util``:

* ``tree_flatten`` / ``tree_unflatten`` / ``flatten_up_to`` / ``tree_map``;
* ``tree_add`` / ``tree_sub`` / ``tree_scale`` / ``tree_axpy`` /
  ``tree_zeros_like`` / ``tree_select``;
* ``tree_blowup`` — the divergence guard's one primitive.  The port writes
  the path batch out as leading axes, so it takes ``batch_dims`` and returns
  one flag per path where the reference, under ``vmap``, returns one per
  lane;
* ``tree_select_paths`` — ``tree_select`` with one predicate per path;
* ``resolve_solver`` — spec string or coefficients to a solver object.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch

__all__ = [
    "tree_flatten",
    "tree_unflatten",
    "flatten_up_to",
    "tree_leaves",
    "tree_map",
    "tree_add",
    "tree_sub",
    "tree_scale",
    "tree_axpy",
    "tree_zeros_like",
    "tree_select",
    "tree_blowup",
    "tree_select_paths",
    "resolve_solver",
]

_LEAF = "leaf"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


# The recursions below are module-level functions that take their
# accumulator as an argument: a nested ``def rec`` that calls itself closes
# over its own cell, and that cycle would keep every leaf it saw (device
# buffers included) alive until Python's cyclic collector happened to run.

def _flatten_into(x, leaves: List[Any]):
    if x is None:
        return None
    if isinstance(x, dict):
        keys = sorted(x)
        return (dict, tuple(keys), tuple(_flatten_into(x[k], leaves) for k in keys))
    if _is_namedtuple(x):
        return (type(x), None, tuple(_flatten_into(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return (type(x), None, tuple(_flatten_into(v, leaves) for v in x))
    leaves.append(x)
    return _LEAF


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; tuples, lists, dicts (sorted keys) and
    namedtuples are nodes, ``None`` is an empty node, anything else a leaf."""
    leaves: List[Any] = []
    treedef = _flatten_into(tree, leaves)
    return leaves, treedef


def _unflatten_from(d, it):
    if d is None:
        return None
    if d == _LEAF:
        return next(it)
    kind, keys, children = d
    vals = [_unflatten_from(c, it) for c in children]
    if kind is dict:
        return dict(zip(keys, vals))
    if kind in (tuple, list):
        return kind(vals)
    return kind(*vals)  # namedtuple


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`."""
    return _unflatten_from(treedef, iter(leaves))


def _flatten_up_to_into(d, x, out: List[Any]) -> None:
    if d is None:
        return
    if d == _LEAF:
        out.append(x)
        return
    kind, keys, children = d
    vals = [x[k] for k in keys] if kind is dict else list(x)
    if len(vals) != len(children):
        raise ValueError(f"tree structure mismatch: {len(vals)} vs "
                         f"{len(children)} children")
    for c, v in zip(children, vals):
        _flatten_up_to_into(c, v, out)


def flatten_up_to(treedef, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef`` (a
    scalar ``dW`` against a tensor leaf stays whole)."""
    out: List[Any] = []
    _flatten_up_to_into(treedef, tree, out)
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``."""
    leaves, treedef = tree_flatten(tree)
    others = [flatten_up_to(treedef, r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_add(x, y):
    return tree_map(lambda a, b: a + b, x, y)


def tree_sub(x, y):
    return tree_map(lambda a, b: a - b, x, y)


def tree_scale(a, x):
    return tree_map(lambda xi: a * xi, x)


def tree_axpy(a, x, y):
    """a * x + y."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def tree_zeros_like(x):
    return tree_map(torch.zeros_like, x)


def tree_select(pred, a, b):
    """Leafwise ``where(pred, a, b)``."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_select_paths(pred, a, b):
    """Leafwise ``where(pred, a, b)`` with ``pred`` one bool per path (shape
    ``batch``), broadcast over each leaf's trailing axes; a Python bool
    picks a whole tree."""
    if not isinstance(pred, torch.Tensor):
        return a if pred else b
    return tree_map(lambda x, y: torch.where(
        pred.reshape(tuple(pred.shape) + (1,) * (x.dim() - pred.dim())), x, y),
        a, b)


def tree_blowup(x, threshold=None, batch_dims: int = 0) -> torch.Tensor:
    """Bool tensor of shape ``batch``: does any floating leaf entry of a path
    go non-finite (or, with a finite ``threshold``, above it in magnitude)?

    ``batch_dims`` leading axes of every leaf index independent paths and
    are kept; the rest are reduced.  A pure observer: it never feeds back
    into the state.  For a finite threshold ``~(|x| <= thr)`` flags NaN and
    ±Inf too (they fail ``<=``); ``None`` or ``inf`` checks finiteness only.
    """
    finite_thr = threshold is not None and not (
        isinstance(threshold, float) and math.isinf(threshold))
    flags = None
    for leaf in tree_leaves(x):
        arr = torch.as_tensor(leaf)
        if not arr.is_floating_point():
            continue
        if finite_thr:
            bad = ~(arr.abs() <= threshold)
        else:
            bad = ~torch.isfinite(arr)
        bad = bad.reshape(tuple(arr.shape[:batch_dims]) + (-1,)).any(dim=-1)
        flags = bad if flags is None else flags | bad
    if flags is None:
        return torch.tensor(False)
    return flags


def resolve_solver(solver, *, require_error_estimate: bool = False):
    """Spec string / LowStorage coefficients / solver object -> solver object.

    ``require_error_estimate=True`` also demands ``step_with_error`` (the
    embedded estimator grid realization needs) and raises otherwise;
    solvers without it (``reversible_heun``, ``mcf-*``) can still solve over
    an already-realized grid.
    """
    if isinstance(solver, str):
        from .registry import get_solver

        solver = get_solver(solver)
    from .williamson import LowStorage

    if isinstance(solver, LowStorage):
        from .solvers import LowStorageSolver

        solver = LowStorageSolver(solver)
    if require_error_estimate and not hasattr(solver, "step_with_error"):
        raise ValueError(
            f"solver {getattr(solver, 'name', solver)!r} has no embedded "
            "error estimate (step_with_error); adaptive grid realization "
            "supports the EES 2N schemes and multi-stage Butcher-form RK — "
            "realize the grid with one of those (or use a fixed grid), then "
            "any solver, including reversible_heun / mcf-*, can solve over "
            "the realized grid"
        )
    return solver
