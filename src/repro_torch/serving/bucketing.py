"""Signature coalescing for the serving plane: padded bucketed dispatch.

Port of ``repro.serving.bucketing`` (pure Python, its own copy).  In the
port a bucket's callable loops each tick's live steps only, so padding
costs no device work at all.

Mixed-signature traffic fragments the executor's compile cache: every
distinct ``(solver, horizon, step count)`` combination is its own request
signature, its own jit executable, and its own (often shallow) tick stacks —
exactly the failure mode continuous batching is supposed to avoid.  This
module maps signatures onto a small set of canonical **buckets** so requests
that differ only in *horizon length* (or path count — slot padding was
always free) share one compiled executable AND can stack into the same tick
dispatch.

A bucket is :class:`BucketKey` ``(solver, t0, h, n_padded)``:

* ``h`` is the request's exact step size ``(t1 - t0) / n_steps`` as a
  Python double.  It stays **static** — closed into the executable — because
  that is what bitwise identity requires: a traced (or gathered) step size
  changes XLA's FMA formation in the step body and drifts results by an ulp.
  Requests coalesce exactly when their ``h`` doubles are bit-equal, i.e.
  when they differ only in how *many* steps they take, which is the mixed
  traffic this layer targets (same process / step-size config, varying
  horizons).
* ``n_padded`` is ``n_steps`` rounded up a powers-of-two ladder
  (:func:`ladder_rung`).  The executable integrates ``n_padded`` steps over
  a :meth:`~repro_torch.core.grid.TimeGrid.padded_uniform` grid; the one traced
  operand is each tick's true step count (``active_steps`` in
  :func:`~repro_torch.core.sdeint.sdeint_ticks`), and padding steps are skipped by
  a batch-uniform ``lax.cond`` whose live branch compiles to exactly the
  unpadded solve — results are **bitwise-identical** to exact dispatch
  (regression-tested across the solver zoo).

Eligibility (:func:`bucket_eligible`): fixed-grid requests with no saved
trajectory and no adaptive options.  Adaptive solves walk data-dependent
grids (padding is meaningless), and ``save_every``/``save_at`` outputs have
signature-dependent shapes; those requests keep their exact per-signature
executables (``group_key`` wraps them as ``("exact", signature)`` groups),
so turning bucketing on never changes *what* any request receives — only
how many executables a mixed stream compiles.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.registry import parse_solver_spec

__all__ = [
    "BucketingConfig",
    "BucketKey",
    "ladder_rung",
    "bucket_eligible",
    "bucket_key",
    "group_key",
]


@dataclasses.dataclass(frozen=True)
class BucketingConfig:
    """How the serving plane coalesces signatures.

    ``enabled=False`` is the exact opt-out: every request keeps its own
    per-signature executable (the pre-PR-8 behaviour).  ``min_steps`` is the
    smallest ladder rung — requests shorter than it still pad up to it, so
    tiny-horizon probes don't each mint an executable.
    """

    enabled: bool = True
    min_steps: int = 8

    def __post_init__(self):
        if self.min_steps < 1:
            raise ValueError(f"min_steps must be >= 1, got {self.min_steps}")


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """One compiled bucket: every request in it shares this executable.

    ``h`` is the exact (bit-equal Python double) step size; ``n_padded`` the
    ladder rung the executable integrates.  Hashable — this is the
    executor's compile-cache key and the scheduler's planning group.
    """

    solver: str
    t0: float
    h: float
    n_padded: int


def ladder_rung(n_steps: int, min_steps: int = 8) -> int:
    """The smallest power-of-two multiple of 1 at or above ``n_steps``,
    floored at ``min_steps``: the padded grid length for ``n_steps``."""
    rung = max(1, int(min_steps))
    while rung < n_steps:
        rung *= 2
    return rung


def bucket_eligible(signature: Tuple) -> bool:
    """Whether a request signature can run on a padded bucket executable.

    Fixed-grid, final-state-only requests qualify; adaptive solves and
    saved-trajectory requests (``save_every``/``save_at``) dispatch exact.
    """
    solver, _t0, _t1, _n_steps, save_every, rtol, atol, save_at = signature
    if save_every is not None or save_at is not None:
        return False
    if rtol is not None or atol is not None:
        return False
    if parse_solver_spec(solver)[1].get("adaptive", False):
        return False
    return True


def bucket_key(signature: Tuple,
               cfg: BucketingConfig) -> Optional[BucketKey]:
    """The bucket a signature coalesces into, or None (ineligible/disabled)."""
    if not cfg.enabled or not bucket_eligible(signature):
        return None
    solver, t0, t1, n_steps = signature[:4]
    # Exact double arithmetic: two signatures share a bucket iff this
    # division lands on the same bits — the condition for the static-h
    # executable to reproduce both bitwise.
    h = (t1 - t0) / n_steps
    return BucketKey(solver=solver, t0=t0, h=h,
                     n_padded=ladder_rung(n_steps, cfg.min_steps))


def group_key(signature: Tuple, cfg: BucketingConfig):
    """The scheduler's planning-group key for a signature: its
    :class:`BucketKey` when bucketable, else the exact signature (tagged, so
    a bucket and a raw signature can never collide as dict keys)."""
    bk = bucket_key(signature, cfg)
    return bk if bk is not None else ("exact", signature)
