"""The time grid a solve integrates over.

Port of the fixed-grid half of ``repro.core.grid.TimeGrid``: uniform grids
(:meth:`TimeGrid.uniform`, :meth:`TimeGrid.from_path`) and the padded
uniform grid of bucketed serving (:meth:`TimeGrid.padded_uniform`).
Realized (adaptive) grids come with the adaptive slice.

``ts`` is a tensor in the draw dtype on the driver's device, computed with
the reference's expression ``t0 + n * h`` so stage times carry the same
bits; the uniform step ``h`` stays a Python float.  A padded grid's live
step count ``n_active`` is a Python int: the solve loop runs exactly the
live steps and never syncs with the device to find them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..device import resolve_device

__all__ = ["TimeGrid"]


def _grid_placement(driver, dtype, device):
    if dtype is None:
        dtype = getattr(driver, "dtype", torch.float32)
    key = getattr(driver, "key", None)
    if device is None and isinstance(key, torch.Tensor):
        return dtype, key.device
    return dtype, resolve_device(device)


@dataclasses.dataclass(frozen=True)
class TimeGrid:
    """A uniform step grid plus the driver that feeds it.

    ``ts`` has shape ``(n_steps + 1,)``; step ``n`` runs over
    ``[ts[n], ts[n+1]]`` with size ``uniform_h`` and increment
    ``increment(n)``.  ``n_active`` (padded grids only) is the number of
    live steps; steps at or past it are never run.
    """

    ts: torch.Tensor
    driver: Any
    t0: float
    t1: float
    uniform_h: float
    n_active: Optional[int] = None

    @property
    def n_steps(self) -> int:
        return self.ts.shape[0] - 1

    @property
    def is_padded(self) -> bool:
        return self.n_active is not None

    @property
    def n_live(self) -> int:
        """Steps a solve runs: ``n_active`` on a padded grid, else all."""
        return self.n_active if self.is_padded else self.n_steps

    def t_of(self, n: int) -> torch.Tensor:
        return self.ts[n]

    def h_of(self, n: int) -> float:
        return self.uniform_h

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
        if self.is_padded:
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
        if self.is_padded:
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
