"""Fleet health for training runs (port of ``repro.train.fault_tolerance``;
numpy only, re-implemented so that the port imports nothing of the
reference).

* :class:`HeartbeatMonitor` — per-host liveness with a deadline; a launcher
  polls ``dead_hosts()`` and restarts when it is not empty.
* :class:`StragglerTracker` — rolling per-step times; flags hosts whose
  median exceeds the fleet's median by ``k`` median absolute deviations.
  ``record_chunk`` records a fused multi-step dispatch as one per-step
  average.
* :func:`recovery_plan` — drops every pod that holds a dead host and names
  the checkpoint step to resume from.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["HeartbeatMonitor", "StragglerTracker", "RecoveryPlan",
           "recovery_plan"]


class HeartbeatMonitor:
    """Per-host liveness.  Hosts named at construction start the deadline
    clock at once; unknown hosts register on their first ``beat``."""

    def __init__(self, hosts: Sequence[int], deadline_s: float = 60.0):
        self.deadline_s = deadline_s
        self._last: Dict[int, float] = {h: time.monotonic() for h in hosts}

    def beat(self, host: int, now: Optional[float] = None):
        self._last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self._last.items() if now - t > self.deadline_s]


class StragglerTracker:
    """Flags hosts persistently slower than the fleet (``k`` MADs over the
    median of the per-host medians, hosts with at least 8 samples)."""

    def __init__(self, hosts: Sequence[int], window: int = 32, k: float = 4.0):
        self.window = window
        self.k = k
        self._times: Dict[int, List[float]] = {h: [] for h in hosts}

    def record(self, host: int, step_time_s: float):
        buf = self._times.setdefault(host, [])
        buf.append(step_time_s)
        if len(buf) > self.window:
            buf.pop(0)

    def record_chunk(self, host: int, chunk_time_s: float, n_steps: int):
        """Record a dispatch of ``n_steps`` fused steps as ONE sample, its
        per-step average (the window then fills once a chunk)."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        self.record(host, chunk_time_s / n_steps)

    def stragglers(self) -> List[int]:
        med_per_host = {h: float(np.median(v)) for h, v in self._times.items()
                        if len(v) >= 8}
        if len(med_per_host) < 2:
            return []
        vals = np.array(list(med_per_host.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        return [h for h, v in med_per_host.items() if v > med + self.k * mad]


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    new_mesh_shape: Tuple[int, ...]
    resume_step: int
    dropped_hosts: Tuple[int, ...]


def recovery_plan(mesh_shape: Tuple[int, ...], hosts_per_pod: int,
                  dead_hosts: Sequence[int],
                  latest_ckpt_step: int) -> RecoveryPlan:
    """Shrink the leading (pod) axis to exclude pods holding dead hosts.

    A ``(data, model)`` mesh is one pod.  Every dead host id must lie in the
    fleet the mesh describes (``0 <= host < pods * hosts_per_pod``), else
    ``ValueError``; no surviving pod raises ``RuntimeError``."""
    if len(mesh_shape) == 2:
        mesh_shape = (1,) + tuple(mesh_shape)
    pods, data, model = mesh_shape
    fleet = pods * hosts_per_pod
    for h in dead_hosts:
        if not 0 <= int(h) < fleet:
            raise ValueError(
                f"dead host {h} is outside the fleet: mesh {tuple(mesh_shape)}"
                f" with hosts_per_pod={hosts_per_pod} has host ids 0.."
                f"{fleet - 1}")
    dead_pods = sorted({h // hosts_per_pod for h in dead_hosts})
    surviving = pods - len(dead_pods)
    if surviving < 1:
        raise RuntimeError("no surviving pods")
    return RecoveryPlan(new_mesh_shape=(surviving, data, model),
                        resume_step=latest_ckpt_step,
                        dropped_hosts=tuple(dead_hosts))
