"""The time grid a solve integrates over.

Port of ``repro.core.grid``: uniform grids (:meth:`TimeGrid.uniform`,
:meth:`TimeGrid.from_path`), the padded uniform grid of bucketed serving
(:meth:`TimeGrid.padded_uniform`) and realized (adaptive) grids, built by
:func:`repro_torch.core.adaptive.realize_grid`; plus the dense-output
helpers :func:`fill_saves` and :func:`save_mask` that the controller and
every adjoint share.

A uniform grid's ``ts`` is a tensor in the draw dtype on the driver's
device, computed with the reference's expression ``t0 + n * h`` so stage
times carry the same bits; its step ``h`` stays a Python float, so every
fixed-grid solve runs exactly as before.  A padded grid's live step count
``n_active`` is a Python int: the solve loop runs exactly the live steps
and never syncs with the device to find them.

A realized grid is batched where the reference vmaps: ``ts`` is
``(*batch, n_steps + 1)`` and ``hs`` ``(*batch, n_steps)``, float64, one row
per path, each row padded at its tail with zero-length steps (``h == 0``),
which every solve masks out.  Its ``n_active`` is the largest number of
accepted steps in the batch: no path steps past it, so solves stop there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from .pytree import tree_map

__all__ = ["TimeGrid", "fill_saves", "save_mask", "save_times"]


def _grid_placement(driver, dtype, device):
    if dtype is None:
        dtype = getattr(driver, "dtype", torch.float32)
    key = getattr(driver, "key", None)
    if device is None and isinstance(key, torch.Tensor):
        return dtype, key.device
    return dtype, resolve_device(device)


def _per_path(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-path values ``x`` (shape ``batch``) in ``like``'s dtype, with
    trailing unit axes to broadcast against ``like`` (``(*batch, ...)``)."""
    return x.to(like.dtype).reshape(tuple(x.shape)
                                    + (1,) * (like.dim() - x.dim()))


@dataclasses.dataclass(frozen=True)
class TimeGrid:
    """A (possibly non-uniform) step grid plus the driver that feeds it.

    Step ``n`` runs over ``[ts[..., n], ts[..., n+1]]`` with size
    ``h_of(n)`` and increment ``increment(n)``.  ``uniform_h`` is set (a
    Python float) iff the grid is uniform, and ``ts`` is then
    ``(n_steps + 1,)``; a realized grid carries per-path rows ``ts``
    ``(*batch, n_steps + 1)`` and ``hs`` ``(*batch, n_steps)`` instead.
    ``n_active`` is the number of leading steps a solve runs: a padded
    grid's live steps, a realized grid's largest accepted count; None runs
    all.  ``t0``/``t1`` are the nominal window.
    """

    ts: torch.Tensor
    driver: Any
    t0: float
    t1: float
    uniform_h: Optional[float] = None
    n_active: Optional[int] = None
    hs: Optional[torch.Tensor] = None

    @property
    def n_steps(self) -> int:
        return self.ts.shape[-1] - 1

    @property
    def is_uniform(self) -> bool:
        return self.uniform_h is not None

    @property
    def is_padded(self) -> bool:
        """A :meth:`padded_uniform` grid: uniform steps, ``n_active`` live."""
        return self.n_active is not None and self.is_uniform

    @property
    def n_live(self) -> int:
        """Steps a solve runs: ``n_active`` when set, else all."""
        return self.n_active if self.n_active is not None else self.n_steps

    def t_of(self, n: int) -> torch.Tensor:
        return self.ts[..., n]

    def h_of(self, n: int):
        """The step size: the Python float of a uniform grid, else the
        per-path ``hs[..., n]``."""
        if self.uniform_h is not None:
            return self.uniform_h
        return self.hs[..., n]

    def live(self, n: int):
        """Which paths step ``n`` moves: True on a uniform grid, else the
        per-path ``hs[..., n] > 0`` (padding steps are no-ops)."""
        return True if self.is_uniform else self.hs[..., n] > 0

    def step_th(self, n: int, like: torch.Tensor):
        """``(t, h)`` of step ``n`` as a solver takes them: a uniform grid's
        ``(ts[n], uniform_h)``; on a realized grid the per-path float64
        times cast to the state leaf ``like``'s dtype, shaped to broadcast
        against it (every leaf of the state must share ``like``'s rank)."""
        if self.is_uniform:
            return self.ts[n], self.uniform_h
        return _per_path(self.ts[..., n], like), _per_path(self.hs[..., n], like)

    def increment(self, n: int):
        """dW over step ``n`` (None in ODE mode)."""
        if self.driver is None:
            return None
        return self.driver.grid_increment(self.ts, n)

    def increments(self):
        """Every live step's increment, stacked on a leading axis (the bulk
        realization solves stream from); None in ODE mode or for a driver
        without a bulk path.  Padded grids realize their live prefix only."""
        if self.driver is None or not hasattr(self.driver, "grid_increments"):
            return None
        if self.n_active is not None:
            return self.driver.grid_increments(self.ts, n_rows=self.n_active)
        return self.driver.grid_increments(self.ts)

    def _require_levy(self):
        if self.driver is None:
            raise ValueError(
                "this solver needs space-time Levy areas but the grid has no "
                "Brownian driver (ODE mode)"
            )
        if not hasattr(self.driver, "grid_levy_increment"):
            raise ValueError(
                f"this solver needs space-time Levy areas but driver "
                f"{type(self.driver).__name__} has no grid_levy_increment — "
                "use a BrownianPath or VirtualBrownianTree"
            )

    def levy_increment(self, n: int):
        """The ``(dW, dH)`` pair over step ``n`` for Levy-area solvers (SRA1)."""
        self._require_levy()
        return self.driver.grid_levy_increment(self.ts, n)

    def levy_increments(self):
        """Every live step's ``(dW, dH)`` pair, stacked (the bulk realization
        of Levy-area solvers); None for a driver without a bulk path."""
        self._require_levy()
        if not hasattr(self.driver, "grid_levy_increments"):
            return None
        if self.n_active is not None:
            return self.driver.grid_levy_increments(self.ts,
                                                    n_rows=self.n_active)
        return self.driver.grid_levy_increments(self.ts)

    @classmethod
    def uniform(cls, t0: float, t1: float, n_steps: int, driver=None, *,
                dtype=None, device=None) -> "TimeGrid":
        """Uniform ``n_steps``-step grid over ``[t0, t1]``; ``driver=None``
        is ODE mode.  ``dtype``/``device`` default to the driver's (its draw
        dtype and its key's device), else float32 on ``"cuda"``."""
        t0, t1 = float(t0), float(t1)
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError(f"need n_steps >= 1, got {n_steps}")
        dtype, device = _grid_placement(driver, dtype, device)
        h = (t1 - t0) / n_steps
        ts = torch.arange(n_steps + 1, dtype=dtype, device=device) * h + t0
        return cls(ts, driver, t0, t1, uniform_h=h)

    @classmethod
    def from_path(cls, bm) -> "TimeGrid":
        """The native grid of a :class:`~repro_torch.core.brownian.BrownianPath`."""
        return cls.uniform(bm.t0, bm.t1, bm.n_steps, driver=bm)

    @classmethod
    def padded_uniform(cls, t0: float, h: float, n_active: int, n_padded: int,
                       driver=None, *, dtype=None, device=None) -> "TimeGrid":
        """Uniform grid of ``n_padded`` steps of exact size ``h``, of which the
        first ``n_active`` are live; live times equal
        :meth:`uniform` ``(t0, t0 + n_active*h, n_active)``'s bitwise."""
        t0, h = float(t0), float(h)
        n_padded = int(n_padded)
        if n_padded < 1:
            raise ValueError(f"need n_padded >= 1, got {n_padded}")
        if isinstance(n_active, torch.Tensor) and n_active.dim() != 0:
            raise ValueError(
                f"n_active must be a scalar (one live-step count per grid), "
                f"got shape {tuple(n_active.shape)}"
            )
        n_active = int(n_active)
        if not 0 <= n_active <= n_padded:
            raise ValueError(f"n_active={n_active} outside [0, {n_padded}]")
        dtype, device = _grid_placement(driver, dtype, device)
        idx = torch.arange(n_padded + 1, dtype=dtype, device=device)
        ts = idx.clamp(max=n_active) * h + t0
        return cls(ts, driver, t0, t0 + n_padded * h, uniform_h=h,
                   n_active=n_active)


def save_times(save_at, device) -> torch.Tensor:
    """``save_at`` (a sequence or array of times) as a 1-D float64 tensor on
    ``device``."""
    if isinstance(save_at, torch.Tensor):
        save_ts = save_at.detach().to(device=device, dtype=torch.float64)
    else:
        save_ts = torch.as_tensor(np.asarray(save_at, dtype=np.float64),
                                  device=device)
    if save_ts.dim() != 1:
        raise ValueError(f"save_at must be 1-D, got shape {tuple(save_ts.shape)}")
    return save_ts


def save_mask(save_ts, live, t_old, t_new, t1, eps_end):
    """Which save points step ``[t_old, t_new]`` covers: ``(n_saves,
    *t_old.shape)``, disjoint across steps.

    A step owns the half-open interval ``(t_old, t_new]``; only the step
    reaching ``t1`` extends its claim by ``eps_end``, so a save at exactly
    ``t1`` survives rounding and no interior save is claimed twice.  The
    forward fill and the reversible backward's cotangent injection share it.
    Times are float64; ``t_old``/``t_new`` are scalars or one per path.
    """
    t_old = torch.as_tensor(t_old, dtype=torch.float64, device=save_ts.device)
    t_new = torch.as_tensor(t_new, dtype=torch.float64, device=save_ts.device)
    ts = save_ts.reshape(save_ts.shape + (1,) * t_old.dim())
    slack = torch.where(t_new >= t1 - eps_end, eps_end, 0.0)
    return (ts > t_old) & (ts <= t_new + slack) & live


def save_weights(save_ts, t_old, t_new, h_floor):
    """Each save point's interpolation weight of ``y_new`` over step
    ``[t_old, t_new]``, clipped to ``[0, 1]``: ``(n_saves, *t_old.shape)``."""
    t_old = torch.as_tensor(t_old, dtype=torch.float64, device=save_ts.device)
    t_new = torch.as_tensor(t_new, dtype=torch.float64, device=save_ts.device)
    ts = save_ts.reshape(save_ts.shape + (1,) * t_old.dim())
    return torch.clamp((ts - t_old) / torch.clamp_min(t_new - t_old, h_floor),
                       0.0, 1.0)


def _over_leaf(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``(n_saves, *batch)`` weights or masks shaped to broadcast against a
    save buffer leaf ``(n_saves, *batch, ...)``."""
    return x.reshape(tuple(x.shape) + (1,) * (leaf.dim() - x.dim()))


def fill_saves(ys_out, save_ts, live, t_old, t_new, y_old, y_new,
               t1, eps_end, h_floor):
    """Write the save points one step covers into the dense-output buffer
    (leaves ``(n_saves, *batch, ...)``): linear interpolation between
    ``y_old`` at ``t_old`` and ``y_new`` at ``t_new`` at every save the step
    owns (:func:`save_mask`); ``live`` gates out rejected trials and padding
    steps.  The controller and every adjoint share it, so their dense
    outputs agree bitwise."""
    frac = save_weights(save_ts, t_old, t_new, h_floor)
    mask = save_mask(save_ts, live, t_old, t_new, t1, eps_end)

    def leaf(out, a, b):
        f = _over_leaf(frac, out).to(a.dtype)
        return torch.where(_over_leaf(mask, out), a + f * (b - a), out)

    return tree_map(leaf, ys_out, y_old, y_new)
