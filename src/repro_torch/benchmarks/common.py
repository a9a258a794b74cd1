"""Shared harness of the port's benchmarks (port of ``benchmarks/common.py``):
CSV rows, device-synchronised timing, the output file rule, the device
record every payload carries, and for the paper's tables a value-and-grad,
one optimizer step on an ``nn.Module`` and the peak memory of a call."""
from __future__ import annotations

import contextlib
import fnmatch
import json
import os
import socket
import time
from typing import Callable, Optional

import torch

__all__ = ["emit", "time_fn", "synchronize", "device_record", "percentile",
           "check_out", "write_out", "value_and_grad", "opt_step", "peak_bytes",
           "process_world"]


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


@contextlib.contextmanager
def process_world(device: torch.device):
    """The caller's ``torch.distributed`` world, or, when none is initialised,
    a world of one on 127.0.0.1 (NCCL on the card, gloo on the CPU) for the
    body, destroyed after; yields the world size.  The mesh ladders run over
    every rank of it."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield dist.get_world_size()
        return
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield 1
    finally:
        dist.destroy_process_group()


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


def value_and_grad(loss, params: torch.nn.Module, *inputs):
    """``(loss, [grad per parameter])`` of ``loss(params, *inputs)``, as
    ``jax.value_and_grad`` (a parameter the loss does not reach gets
    zeros)."""
    leaves = list(params.parameters())
    val = loss(params, *inputs)
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    return val.detach(), [torch.zeros_like(p) if g is None else g
                          for p, g in zip(leaves, grads)]


def opt_step(loss, params: torch.nn.Module, opt, state, *inputs):
    """One optimizer step on ``params`` (updated in place): returns the
    loss before the step and the new optimizer state."""
    val, grads = value_and_grad(loss, params, *inputs)
    leaves = list(params.parameters())
    new, state, _ = opt.update(grads, state, leaves)
    with torch.no_grad():
        for p, v in zip(leaves, new):
            p.copy_(v)
    return val, state


def peak_bytes(fn: Callable, device: torch.device) -> int:
    """Peak bytes ``fn()`` holds above what was allocated before it: on
    CUDA ``max_memory_allocated`` after ``reset_peak_memory_stats`` (the
    allocator's rounding included), elsewhere the live tensor bytes counted
    op by op (:class:`~repro_torch.benchmarks.step_memory.LiveBytes`)."""
    if device.type != "cuda":
        from .step_memory import LiveBytes

        with LiveBytes() as live:
            fn()
        return live.peak
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - base
