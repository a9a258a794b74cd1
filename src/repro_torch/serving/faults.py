"""Deterministic fault injection for the SDE serving plane.

Port of ``repro.serving.faults`` (its own copy: the reference module imports
jax).  The robustness layer — the blow-up guard, the retry ladder, deadlines
and the async engine's supervised serve loop — is only trustworthy if it can
be exercised: :class:`FaultyExecutor` wraps a
:class:`~repro_torch.serving.executor.TickExecutor` and injects three failure
modes into dispatch, all driven by one seeded ``random.Random`` stream, so
every run sees the identical fault schedule — the same one the reference's
injector draws for the same :class:`FaultConfig`:

* **NaN trajectories** — corrupt chosen (tick, slot) cells of a dispatch's
  outputs *after* the real integration ran, setting the matching
  ``diverged`` flags the way a genuine blow-up would.  Targeted cells
  (``nan_slots``) make isolation tests exact; a rate (``nan_rate``) drives
  statistical sweeps.
* **Executor crashes** — raise :class:`InjectedCrash` (marked ``transient``)
  *instead of* dispatching, before any device work: the failure the sync
  engine's reservation unwind and the async engine's supervised restart must
  survive without losing or duplicating queued paths.
* **Artificial delays** — ``time.sleep`` before dispatching, for deadline and
  straggler scenarios.

:func:`inject_faults` swaps the injector into an existing engine (sync or
async).  Corruption happens to the *outputs* of the real executor, on a copy
and on the executor's stream, so the samples, the cached callables and the
dispatch counters stay those of the clean plane.

:class:`FakeClock` is the matching deterministic time source for deadline
tests: pass it as the engine's ``clock`` and ``advance()`` it explicitly.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional, Tuple

import torch

from ..core.pytree import tree_map

__all__ = ["InjectedCrash", "FaultConfig", "FaultyExecutor", "FakeClock",
           "inject_faults"]


class InjectedCrash(RuntimeError):
    """A dispatch-time crash injected by :class:`FaultyExecutor`.

    ``transient = True`` is the marker the async engine's supervised serve
    loop restarts on; a real (non-transient) executor error still fails the
    engine loudly."""

    transient = True


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Schedule of injected faults; all draws come from ``Random(seed)``.

    ``nan_rate`` / ``crash_rate`` / ``delay_rate`` are per-dispatch
    probabilities (one draw each per dispatch call, in that order, then the
    random cell, so a seed yields one schedule whichever rates are zero).  A
    NaN fault corrupts one uniformly drawn (tick, slot) cell; ``nan_slots``
    names explicit ``(dispatch_index, tick, slot)`` cells to corrupt (rates
    still apply on top).  ``crash_dispatches`` names explicit dispatch
    indices to crash — ``(0,)`` for exactly one crash followed by a clean
    recovery.  ``delay_s`` is the sleep a delay fault injects."""

    seed: int = 0
    nan_rate: float = 0.0
    crash_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 0.0
    nan_slots: Optional[Tuple[Tuple[int, int, int], ...]] = None
    crash_dispatches: Optional[Tuple[int, ...]] = None


class FaultyExecutor:
    """Wrap a ``TickExecutor`` with deterministic faults.

    Everything not overridden here — ``warmup``, ``has_compiled``, the
    stream and its ``landing`` event, the dispatch counters — delegates to
    the wrapped executor, so an engine cannot tell the difference until a
    fault fires.  ``n_crashes`` / ``n_nans`` / ``n_delays`` /
    ``n_dispatch_calls`` record what actually fired."""

    def __init__(self, inner, cfg: FaultConfig = FaultConfig()):
        self.inner = inner
        self.fault_cfg = cfg
        self.rng = random.Random(cfg.seed)
        self.n_dispatch_calls = 0
        self.n_crashes = 0
        self.n_nans = 0
        self.n_delays = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _corrupt(self, result, cells):
        """NaN the given (tick, slot) cells of a dispatch result on a copy,
        setting the matching ``diverged`` flags — indistinguishable
        downstream from a genuine blow-up.  Runs on the executor's stream,
        then records its ``landing`` event again, after the copy."""

        def nan_cell(leaf):
            if not torch.is_floating_point(leaf):
                return leaf
            leaf = leaf.clone()
            for t, s in cells:
                leaf[t, s] = float("nan")
            return leaf

        with self.inner.on_stream():
            updates = {"y_final": tree_map(nan_cell, result.y_final)}
            if result.ys is not None:
                updates["ys"] = tree_map(nan_cell, result.ys)
            if result.diverged is not None:
                div = result.diverged.clone()
                for t, s in cells:
                    div[t, s] = True
                updates["diverged"] = div
            self.inner.record_landing()
        return result._replace(**updates)

    def dispatch(self, key, tick_keys, active_steps=None):
        cfg = self.fault_cfg
        idx = self.n_dispatch_calls
        self.n_dispatch_calls += 1
        # One draw per rate per dispatch, fixed order: the schedule for a
        # seed is independent of which faults are enabled.
        crash = self.rng.random() < cfg.crash_rate
        nan = self.rng.random() < cfg.nan_rate
        delay = self.rng.random() < cfg.delay_rate
        n_ticks, slots = tick_keys.shape[0], tick_keys.shape[1]
        rand_cell = (self.rng.randrange(n_ticks), self.rng.randrange(slots))
        if crash or (cfg.crash_dispatches and idx in cfg.crash_dispatches):
            self.n_crashes += 1
            raise InjectedCrash(f"injected crash at dispatch {idx}")
        if delay and cfg.delay_s > 0:
            self.n_delays += 1
            time.sleep(cfg.delay_s)
        result = self.inner.dispatch(key, tick_keys, active_steps)
        cells = []
        if cfg.nan_slots:
            cells += [(t, s) for d, t, s in cfg.nan_slots
                      if d == idx and t < n_ticks and s < slots]
        if nan:
            cells.append(rand_cell)
        if cells:
            self.n_nans += len(cells)
            result = self._corrupt(result, cells)
        return result


def inject_faults(engine, cfg: FaultConfig = FaultConfig()) -> FaultyExecutor:
    """Swap ``engine``'s executor for a :class:`FaultyExecutor` around it.

    Works on both :class:`~repro_torch.serving.sde_engine.SDESampleEngine`
    and :class:`~repro_torch.serving.async_engine.AsyncSDESampleEngine`
    (whose ``executor`` is a view of its inner sync engine's).  Returns the
    injector, for its fired-fault counters."""
    faulty = FaultyExecutor(engine.executor, cfg)
    inner = getattr(engine, "_eng", engine)  # the async engine wraps a sync one
    inner.executor = faulty
    if engine is not inner:
        engine.executor = faulty
    return faulty


class FakeClock:
    """Deterministic, manually advanced clock for deadline tests: callable
    (a drop-in for ``time.monotonic`` as an engine's ``clock``);
    ``advance(dt)`` moves it forward."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)
