"""Counter-based fixed-grid Brownian drivers.

Port of the fixed-grid half of ``repro.core.brownian``
(:class:`BrownianPath`, :class:`PaddedBrownianPath`); the Virtual Brownian
Tree comes with adaptive grids.  The increment over step ``n`` is
``sqrt(h) * normal(fold_in(key, n), shape)`` with the reference's threefry
key scheme (:mod:`repro_torch.core.prng`), so a seed names the same path in
both packages.

The key may carry leading batch axes (``(*batch, 2)``): increments then have
shape ``(*batch, *shape)``, one independent path per key — the port writes
out the batch axis where the reference vmaps over single-key drivers.

``grid_increments`` is the bulk realization every solve streams from:
vectorized threefry over ``(steps, *batch, *shape)``, with row ``n``
bitwise-equal to ``increment(n)`` (the same elementwise ops on the same
words).  Threefry in int64 torch ops holds about ten times its float32
output while it runs, so the rows are drawn in passes of at most
``BULK_PASS_ELEMENTS`` increments into one preallocated buffer: a long
solve's peak is its buffer plus one pass, and every row is the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from . import prng
from .pytree import tree_flatten, tree_map, tree_unflatten

__all__ = [
    "BrownianPath",
    "brownian_path",
    "PaddedBrownianPath",
    "padded_brownian_path",
]

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

#: Increments one threefry pass of a bulk realization draws at most (a
#: serving tick of 65,536 paths x 8 steps x 16 is one pass).
BULK_PASS_ELEMENTS = 1 << 23


def _is_simple_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, int) for i in x)


def _sqrt_in(h: float, dtype) -> float:
    """``sqrt(h)`` rounded in the draw dtype, as ``jnp.sqrt(asarray(h, dtype))``."""
    np_dtype = _NP_DTYPE[dtype]
    return float(np.sqrt(np_dtype(h)))


def _draw(keys: torch.Tensor, shape, dtype, scale: float):
    """``scale * normal`` per key; a pytree of shapes draws each leaf from
    its own ``split`` key, as the reference does."""
    if _is_simple_shape(shape):
        return scale * prng.normal(keys, shape, dtype)
    leaves, treedef = _shape_leaves(shape)
    subs = prng.split(keys, len(leaves))
    outs = [scale * prng.normal(subs[..., i, :], s, dtype)
            for i, s in enumerate(leaves)]
    return tree_unflatten(treedef, outs)


def _shape_leaves(shape):
    """Flatten a pytree of shape tuples, treating each shape as a leaf."""
    boxed = _box_shapes(shape)
    leaves, treedef = tree_flatten(boxed)
    return [b.shape for b in leaves], treedef


@dataclasses.dataclass(frozen=True)
class _Shape:
    shape: Tuple[int, ...]


def _box_shapes(tree):
    if _is_simple_shape(tree):
        return _Shape(tree)
    if isinstance(tree, dict):
        return {k: _box_shapes(v) for k, v in tree.items()}
    return type(tree)(_box_shapes(v) for v in tree)


def _step_keys(key: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``fold_in(key, n)`` for every step ``lo <= n < hi``: ``(hi - lo, *batch, 2)``."""
    batch_ndim = key.dim() - 1
    steps = torch.arange(lo, hi, dtype=torch.int64, device=key.device)
    return prng.fold_in(key, steps.reshape((hi - lo,) + (1,) * batch_ndim))


def _bulk_draw(key: torch.Tensor, n_rows: int, shape, dtype, scale: float):
    """Rows ``fold_in(key, n)``-drawn for ``n < n_rows``, stacked on a leading
    axis, in passes of at most :data:`BULK_PASS_ELEMENTS` increments."""
    leaves = [shape] if _is_simple_shape(shape) else _shape_leaves(shape)[0]
    per_row = math.prod(key.shape[:-1]) * sum(math.prod(s) for s in leaves)
    rows = max(1, BULK_PASS_ELEMENTS // max(per_row, 1))
    if rows >= n_rows:
        return _draw(_step_keys(key, 0, n_rows), shape, dtype, scale)
    out = None
    for lo in range(0, n_rows, rows):
        hi = min(lo + rows, n_rows)
        part = _draw(_step_keys(key, lo, hi), shape, dtype, scale)
        if out is None:
            out = tree_map(lambda x: x.new_empty((n_rows,) + tuple(x.shape[1:])),
                           part)
        tree_map(lambda o, x: o[lo:hi].copy_(x), out, part)
        del part  # free this pass before the next one draws
    return out


_NATIVE_MSG = ("BrownianPath's native {n}-step grid; increments are indexed "
               "by step (fold_in(key, n)) — use a VirtualBrownianTree for "
               "arbitrary (realized) grids")


def _check_steps(n_grid: int, n_steps: int, what: str):
    if n_grid != n_steps:
        raise ValueError(
            f"grid of {n_grid} steps does not match this {what}"
        )


@dataclasses.dataclass(frozen=True)
class BrownianPath:
    """Fixed-grid Brownian driver over [t0, t1] with ``n_steps`` steps.

    ``shape`` is the shape of one increment (the state shape for diagonal
    noise, ``()`` for scalar noise) or a pytree of shapes.  All increments
    have standard deviation ``sqrt(h)``.
    """

    key: torch.Tensor
    t0: float
    t1: float
    n_steps: int
    shape: Tuple[int, ...]
    dtype: Any = torch.float32

    @property
    def h(self) -> float:
        return (self.t1 - self.t0) / self.n_steps

    def increment(self, n: int):
        """dW over step ``n`` (t_n -> t_{n+1})."""
        sub = prng.fold_in(self.key, n)
        return _draw(sub, self.shape, self.dtype, _sqrt_in(self.h, self.dtype))

    def grid_increment(self, ts, n: int):
        """dW over step ``n`` of ``ts``, which must be this path's own grid
        (increments are indexed by step, ``fold_in(key, n)``)."""
        _check_steps(ts.shape[0] - 1, self.n_steps, _NATIVE_MSG.format(
            n=self.n_steps))
        return self.increment(n)

    def grid_increments(self, ts):
        """Every per-step increment of ``ts`` in one vectorized threefry pass,
        stacked on a leading ``n_steps`` axis; row ``n`` is bitwise-equal to
        :meth:`increment` ``(n)``."""
        _check_steps(ts.shape[0] - 1, self.n_steps, _NATIVE_MSG.format(
            n=self.n_steps))
        return _bulk_draw(self.key, self.n_steps, self.shape, self.dtype,
                          _sqrt_in(self.h, self.dtype))


def brownian_path(key, t0, t1, n_steps, shape=(), dtype=torch.float32) -> BrownianPath:
    """Build a :class:`BrownianPath` (casts ``shape`` lists to tuples)."""
    if isinstance(shape, list):
        shape = tuple(shape)
    return BrownianPath(key, float(t0), float(t1), int(n_steps), shape, dtype)


@dataclasses.dataclass(frozen=True)
class PaddedBrownianPath:
    """Fixed-grid driver parameterised by its exact step size ``h`` and a
    padded grid length — the driver of bucketed serving dispatch.

    Step ``n``'s increment is ``sqrt(h) * normal(fold_in(key, n))``,
    bitwise-identical to a :class:`BrownianPath` over ``[t0, t0 + k*h]``
    with the same key for every live step ``n < k``.
    """

    key: torch.Tensor
    t0: float
    h: float
    n_steps: int
    shape: Tuple[int, ...]
    dtype: Any = torch.float32

    @property
    def t1(self) -> float:
        """End of the *padded* window."""
        return self.t0 + self.n_steps * self.h

    def increment(self, n: int):
        sub = prng.fold_in(self.key, n)
        return _draw(sub, self.shape, self.dtype, _sqrt_in(self.h, self.dtype))

    def _check_grid(self, ts):
        _check_steps(ts.shape[0] - 1, self.n_steps,
                     f"PaddedBrownianPath's {self.n_steps}-step padded grid")

    def grid_increment(self, ts, n: int):
        self._check_grid(ts)
        return self.increment(n)

    def grid_increments(self, ts, n_rows: Optional[int] = None):
        """The first ``n_rows`` (default: all padded) per-step increments in
        one vectorized pass; row ``n`` bitwise-equal to :meth:`increment`
        ``(n)``.  A padded solve asks only for its live prefix."""
        self._check_grid(ts)
        n_rows = self.n_steps if n_rows is None else int(n_rows)
        return _bulk_draw(self.key, n_rows, self.shape, self.dtype,
                          _sqrt_in(self.h, self.dtype))


def padded_brownian_path(key, t0, h, n_steps, shape=(),
                         dtype=torch.float32) -> PaddedBrownianPath:
    """Build a :class:`PaddedBrownianPath` (casts ``shape`` lists to tuples)."""
    if isinstance(shape, list):
        shape = tuple(shape)
    return PaddedBrownianPath(key, float(t0), float(h), int(n_steps), shape, dtype)
