"""Shared harness of the port's serving benchmarks (port of
``benchmarks/common.py``): CSV rows, device-synchronised timing, the output
file rule and the device record every payload carries."""
from __future__ import annotations

import fnmatch
import json
import os
import time
from typing import Callable, Optional

import torch

__all__ = ["emit", "time_fn", "synchronize", "device_record", "percentile",
           "check_out", "write_out"]


def emit(name: str, us_per_call: float, derived) -> None:
    """Print one ``name,us_per_call,derived`` CSV row."""
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, device: torch.device, *, warmup: int = 1,
            iters: int = 3) -> float:
    """Median host wall time per call in microseconds, each call ended by a
    device synchronize."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        synchronize(device)
        times.append(time.perf_counter() - start)
    times.sort()
    return times[len(times) // 2] * 1e6


def device_record(device: torch.device) -> dict:
    """Where a payload's numbers were taken: the device type, and on CUDA
    the card's name and count."""
    if device.type != "cuda":
        return {"platform": device.type}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count()}


def percentile(sorted_xs, q: float) -> float:
    """The reference's nearest-rank percentile of a sorted list."""
    if not sorted_xs:
        return float("nan")
    k = min(len(sorted_xs) - 1, max(0, round(q * (len(sorted_xs) - 1))))
    return sorted_xs[k]


def check_out(path: Optional[str]) -> None:
    """Refuse ``BENCH_*.json`` names: the reference's bench gate owns them."""
    if path is not None and fnmatch.fnmatch(os.path.basename(path), "BENCH_*.json"):
        raise SystemExit("--out must not be named BENCH_*.json: the reference's "
                         "bench gate owns that name")


def write_out(path: Optional[str], payload: dict) -> None:
    if path is not None:
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"# wrote {path}", flush=True)
