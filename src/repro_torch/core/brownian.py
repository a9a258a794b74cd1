"""Counter-based Brownian drivers: fixed-grid paths and the Virtual Brownian Tree.

Port of ``repro.core.brownian``: :class:`BrownianPath` and
:class:`PaddedBrownianPath` (fixed grids) and :class:`VirtualBrownianTree`
(arbitrary query times, for adaptive stepping), behind one driver protocol
(:class:`BrownianDriver`).  The increment over step ``n`` of a fixed grid is
``sqrt(h) * normal(fold_in(key, n), shape)`` with the reference's threefry
key scheme (:mod:`repro_torch.core.prng`), so a seed names the same path in
both packages.

The tree resolves ``W(t)`` by descending ``depth`` levels of a dyadic
bisection of ``[t0, t1]``; the bridge sample at a visited midpoint is drawn
from ``fold_in(key, node)`` (heap index: root 1, children ``2n``/``2n+1``).
Each path of a key batch queries its own ``t``, so its ``node`` sequence is
its own: the draws are one batched ``fold_in`` over a tensor of nodes.
Times are float64 whatever the draw dtype (the reference's
``jnp.result_type(float)`` under x64): whether a descent turns right decides
which normals a path draws.

The key may carry leading batch axes (``(*batch, 2)``): increments then have
shape ``(*batch, *shape)``, one independent path per key — the port writes
out the batch axis where the reference vmaps over single-key drivers.

``levy_area_step`` draws the space-time Levy area ``DH ~ N(0, h/12)`` of a
step from the reference's salted key family
``fold_in(fold_in(key, _LEVY_SALT), n)``, so Levy queries leave the ``W``
bits untouched; ``grid_levy_increment(s)`` return ``(dW, dH)`` pairs, per
step or in bulk, for solvers that need them (SRA1).

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
from typing import Any, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from . import prng
from .pytree import tree_flatten, tree_map, tree_unflatten

__all__ = [
    "BrownianDriver",
    "BrownianPath",
    "brownian_path",
    "PaddedBrownianPath",
    "padded_brownian_path",
    "VirtualBrownianTree",
    "virtual_brownian_tree",
]

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

# Key-space salt of the Levy-area stream ("LEVY" in ASCII), as in the
# reference: fold_in(key, _LEVY_SALT) derives an independent key family.
_LEVY_SALT = 0x4C455659

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


@runtime_checkable
class BrownianDriver(Protocol):
    """What a Brownian driver provides: increments over time intervals.

    ``increment_over(s, t)`` is ``W(t) - W(s)``; ``grid_increment(ts, n)``
    the increment over step ``n`` of the grid ``ts``, recomputable in any
    order (the reversible adjoint's backward sweep relies on it).  The bulk
    form ``grid_increments(ts)`` stacks every step's increment, row ``n``
    bitwise-equal to ``grid_increment(ts, n)``.
    """

    t0: float
    t1: float

    def increment_over(self, s, t): ...

    def grid_increment(self, ts, n): ...


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

    def t_of(self, n):
        return self.t0 + n * self.h

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

    def levy_area_step(self, n: int):
        """Space-time Levy area ``DH`` over step ``n``: ``N(0, h/12)``, from
        ``fold_in(fold_in(key, _LEVY_SALT), n)`` (``W`` bits untouched)."""
        return _levy_draw(self.key, n, self.shape, self.dtype, self.h)

    def grid_levy_increment(self, ts, n: int):
        """The ``(dW, dH)`` pair over step ``n`` of this path's own grid."""
        return self.grid_increment(ts, n), self.levy_area_step(n)

    def grid_levy_increments(self, ts):
        """Every step's ``(dW, dH)`` pair, stacked on a leading axis; row
        ``n`` bitwise-equal to :meth:`grid_levy_increment` ``(ts, n)``."""
        return (self.grid_increments(ts),
                _bulk_levy(self.key, self.n_steps, self.shape, self.dtype,
                           self.h))

    def path(self):
        """The cumulative path ``W_{t_n}``, shape ``(n_steps + 1, *batch,
        *shape)`` (a pytree of such for a pytree of shapes): one bulk draw and
        a cumulative sum, realized once per driver and cached."""
        cached = self.__dict__.get("_path_cache")
        if cached is not None:
            return cached
        incs = _bulk_draw(self.key, self.n_steps, self.shape, self.dtype,
                          _sqrt_in(self.h, self.dtype))
        w = tree_map(lambda x: torch.cat(
            [torch.zeros_like(x[:1]), torch.cumsum(x, dim=0)]), incs)
        object.__setattr__(self, "_path_cache", w)
        return w

    def increment_over(self, s, t):
        """``W(t) - W(s)`` for grid-aligned ``s < t``: both are rounded to the
        nearest grid node and read out of :meth:`path` (two gathers)."""
        n0 = _nearest_node(s, self.t0, self.h)
        n1 = _nearest_node(t, self.t0, self.h)
        return tree_map(lambda x: x[n1] - x[n0], self.path())


def _nearest_node(t, t0: float, h: float):
    """The grid index nearest ``t`` (half to even, as ``jnp.round``)."""
    if isinstance(t, torch.Tensor):
        return torch.round((t.to(torch.float64) - t0) / h).to(torch.int64)
    return int(np.round((float(t) - t0) / h))


def _levy_draw(key, n, shape, dtype, h):
    sub = prng.fold_in(prng.fold_in(key, _LEVY_SALT), n)
    return _draw(sub, shape, dtype, _sqrt_in(h / 12.0, dtype))


def _bulk_levy(key, n_rows, shape, dtype, h):
    return _bulk_draw(prng.fold_in(key, _LEVY_SALT), n_rows, shape, dtype,
                      _sqrt_in(h / 12.0, dtype))


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

    def t_of(self, n):
        return self.t0 + n * self.h

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

    def levy_area_step(self, n: int):
        """Space-time Levy area over step ``n``: the same salted key family
        as :meth:`BrownianPath.levy_area_step`."""
        return _levy_draw(self.key, n, self.shape, self.dtype, self.h)

    def grid_levy_increment(self, ts, n: int):
        self._check_grid(ts)
        return self.increment(n), self.levy_area_step(n)

    def grid_levy_increments(self, ts, n_rows: Optional[int] = None):
        """The first ``n_rows`` (default: all padded) ``(dW, dH)`` pairs,
        stacked; row ``n`` bitwise-equal to :meth:`grid_levy_increment`."""
        n_rows = self.n_steps if n_rows is None else int(n_rows)
        return (self.grid_increments(ts, n_rows),
                _bulk_levy(self.key, n_rows, self.shape, self.dtype, self.h))


def padded_brownian_path(key, t0, h, n_steps, shape=(),
                         dtype=torch.float32) -> PaddedBrownianPath:
    """Build a :class:`PaddedBrownianPath` (casts ``shape`` lists to tuples)."""
    if isinstance(shape, list):
        shape = tuple(shape)
    return PaddedBrownianPath(key, float(t0), float(h), int(n_steps), shape, dtype)


# ---------------------------------------------------------------------------
# Virtual Brownian Tree.
# ---------------------------------------------------------------------------

# 2*node+1 must stay inside int32 for fold_in: node < 2^(depth+1).
_MAX_DEPTH = 28
#: The dtype of every time the tree and the adaptive controller compute with.
TIME_DTYPE = torch.float64


def _trail(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with ``n`` trailing unit axes (to broadcast over a draw shape)."""
    return x.reshape(tuple(x.shape) + (1,) * n)


@dataclasses.dataclass(frozen=True)
class VirtualBrownianTree:
    """Brownian motion queryable at arbitrary ``t`` in O(1) memory.

    ``weval(t)`` descends ``depth`` levels of a dyadic bisection of
    ``[t0, t1]`` (``depth`` from ``tol``); the bridge sample at each visited
    midpoint comes from ``fold_in(key, node)``, so ``W(t)`` is a pure
    function of ``(key, t)``.  Below the leaf resolution the path is the
    bridge's conditional mean (linear interpolation).  Increments telescope
    to rounding, which keeps accept/reject stepping on one fixed path.

    ``key`` is ``(*batch, 2)``: one independent path per key.  A query time
    is a float, or a float64 tensor broadcastable to ``batch`` (one time per
    path); bulk queries put a leading node axis in front of ``batch``.
    Values have shape ``(*lead, *batch, *shape)``.
    """

    key: torch.Tensor
    t0: float
    t1: float
    shape: Tuple[int, ...] = ()
    dtype: Any = torch.float32
    tol: float = 2.0 ** -12

    @property
    def depth(self) -> int:
        span = self.t1 - self.t0
        return max(1, min(_MAX_DEPTH, int(math.ceil(math.log2(span / self.tol)))))

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.key.shape[:-1])

    def _time(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=TIME_DTYPE, device=self.key.device)

    def _leaf_eval(self, key, shape, t):
        """W(t) for one pytree leaf, from that leaf's key (``key.shape[:-1]``
        broadcasts against ``t``'s shape)."""
        span = self.t1 - self.t0
        k = len(shape)
        tau = torch.clamp((self._time(t) - self.t0) / span, 0.0, 1.0)
        tau = tau.expand(torch.broadcast_shapes(tau.shape, key.shape[:-1]))
        w_end = _sqrt_in(span, self.dtype) * prng.normal(
            prng.fold_in(key, 0), shape, self.dtype)
        quarter = float(_NP_DTYPE[self.dtype](0.25 * span))
        s = torch.zeros_like(tau)
        u = torch.ones_like(tau)
        ws = torch.zeros(shape, dtype=self.dtype, device=tau.device)
        wu = w_end
        node = 1
        for _ in range(self.depth):
            m = 0.5 * (s + u)
            std = torch.sqrt(quarter * (u - s).to(self.dtype))
            wm = 0.5 * (ws + wu) + _trail(std, k) * prng.normal(
                prng.fold_in(key, node), shape, self.dtype)
            right = tau > m
            s = torch.where(right, m, s)
            u = torch.where(right, u, m)
            rk = _trail(right, k)
            ws = torch.where(rk, wm, ws)
            wu = torch.where(rk, wu, wm)
            node = 2 * node + right.to(torch.int64)
        frac = ((tau - s) / (u - s)).to(self.dtype)
        return ws + _trail(frac, k) * (wu - ws)

    def weval(self, t):
        """``W(t) - W(t0)`` as a pytree matching ``shape`` (``W(t0) == 0``
        exactly)."""
        if _is_simple_shape(self.shape):
            return self._leaf_eval(self.key, self.shape, t)
        leaves, treedef = _shape_leaves(self.shape)
        subs = prng.split(self.key, len(leaves))
        return tree_unflatten(treedef, [
            self._leaf_eval(subs[..., i, :], s, t) for i, s in enumerate(leaves)])

    def increment_over(self, s, t):
        """``W(t) - W(s)`` for ``t0 <= s <= t <= t1`` (two descents)."""
        return tree_map(lambda b, a: b - a, self.weval(t), self.weval(s))

    def levy_area(self, s, t):
        """Space-time Levy area ``DH ~ N(0, (t-s)/12)`` over ``[s, t]``, keyed
        on the endpoints quantized to the leaf resolution in the salted key
        family (``fold_in(key, _LEVY_SALT)``): a pure function of
        ``(key, s, t)``, leaving the ``W`` draws untouched."""
        span = self.t1 - self.t0
        res = 2.0 ** self.depth
        s, t = self._time(s), self._time(t)
        i0 = torch.round((s - self.t0) / span * res).to(torch.int64)
        i1 = torch.round((t - self.t0) / span * res).to(torch.int64)
        sub = prng.fold_in(prng.fold_in(prng.fold_in(self.key, _LEVY_SALT), i0),
                           i1)
        scale = torch.sqrt(torch.clamp_min(t - s, 0.0).to(self.dtype) / 12.0)
        if _is_simple_shape(self.shape):
            return _trail(scale, len(self.shape)) * prng.normal(
                sub, self.shape, self.dtype)
        leaves, treedef = _shape_leaves(self.shape)
        subs = prng.split(sub, len(leaves))
        return tree_unflatten(treedef, [
            _trail(scale, len(sh)) * prng.normal(subs[..., i, :], sh, self.dtype)
            for i, sh in enumerate(leaves)])

    def levy_increment_over(self, s, t):
        """The ``(dW, dH)`` pair over ``[s, t]``."""
        return self.increment_over(s, t), self.levy_area(s, t)

    def grid_increment(self, ts, n: int):
        """dW over step ``n`` of a grid ``ts``: ``(n_steps + 1,)`` shared by
        every path, or ``(*batch, n_steps + 1)`` (a realized grid, one row
        per path)."""
        return self.increment_over(ts[..., n], ts[..., n + 1])

    def grid_levy_increment(self, ts, n: int):
        """The ``(dW, dH)`` pair over step ``n`` of ``ts``."""
        return self.grid_increment(ts, n), self.levy_area(ts[..., n],
                                                          ts[..., n + 1])

    def _nodes(self, ts, n_rows):
        """The first ``n_rows + 1`` grid times on a leading node axis,
        broadcastable against ``batch``."""
        nodes = ts[..., :n_rows + 1].to(TIME_DTYPE)
        if nodes.dim() == 1:
            return nodes.reshape((-1,) + (1,) * len(self.batch_shape))
        return nodes.movedim(-1, 0)

    def _rows_per_pass(self) -> int:
        leaves = [self.shape] if _is_simple_shape(self.shape) else \
            _shape_leaves(self.shape)[0]
        per_row = math.prod(self.batch_shape) * sum(math.prod(s) for s in leaves)
        return max(1, BULK_PASS_ELEMENTS // max(per_row, 1))

    def grid_increments(self, ts, n_rows: Optional[int] = None):
        """The first ``n_rows`` (default: all) step increments of ``ts``,
        stacked on a leading axis: ``W`` at every grid node in one batched
        level-sweep (in passes of at most :data:`BULK_PASS_ELEMENTS` values
        a node), differenced.  Row ``n`` is bitwise-equal to
        :meth:`grid_increment` ``(ts, n)``."""
        n_rows = ts.shape[-1] - 1 if n_rows is None else int(n_rows)
        nodes = self._nodes(ts, n_rows)
        per = self._rows_per_pass()
        out, prev = None, None
        for lo in range(0, n_rows + 1, per):
            w = self.weval(nodes[lo:lo + per])
            if prev is not None:
                w = tree_map(lambda p, x: torch.cat([p, x]), prev, w)
            diffs = tree_map(lambda x: x[1:] - x[:-1], w)
            if out is None:
                out = tree_map(lambda x: x.new_empty((n_rows,) + tuple(x.shape[1:])),
                               diffs)
            start = max(lo - 1, 0)
            tree_map(lambda o, d: o[start:start + d.shape[0]].copy_(d), out, diffs)
            prev = tree_map(lambda x: x[-1:], w)
            del w, diffs
        return out

    def grid_levy_increments(self, ts, n_rows: Optional[int] = None):
        """The first ``n_rows`` ``(dW, dH)`` pairs of ``ts``, stacked; row
        ``n`` bitwise-equal to :meth:`grid_levy_increment` ``(ts, n)``."""
        n_rows = ts.shape[-1] - 1 if n_rows is None else int(n_rows)
        nodes = self._nodes(ts, n_rows)
        return (self.grid_increments(ts, n_rows),
                self.levy_area(nodes[:-1], nodes[1:]))


def virtual_brownian_tree(key, t0, t1, shape=(), dtype=torch.float32,
                          tol=None) -> VirtualBrownianTree:
    """Build a :class:`VirtualBrownianTree` over ``[t0, t1]``; ``tol`` is the
    leaf resolution in time units (default ``(t1 - t0) / 4096``)."""
    if isinstance(shape, list):
        shape = tuple(shape)
    if tol is None:
        tol = (float(t1) - float(t0)) * 2.0 ** -12
    return VirtualBrownianTree(key, float(t0), float(t1), shape, dtype,
                               float(tol))
