"""Monte-Carlo sampling throughput: trajectories/s against batch size.

Port of ``benchmarks/bench_throughput.py``'s single-device ladder (``run``;
its mesh ladder waits for the port's data parallelism).  Times the batched
``sdeint`` fan-out — the serving engine's hot path — for each solver and
batch size on the reference's OU term, with bulk Brownian increments (the
default) and again with per-step increments (``bulk_increments=False``), so
each record carries its own ``speedup_bulk``::

    {"solver": "ees25", "batch_size": 256, "n_steps": 64, "traj_per_sec": ...,
     "steps_per_sec": ..., "us_per_call": ..., "us_per_call_per_step_noise":
     ..., "speedup_bulk": ...}

Times are host wall clock per call ending in a device synchronize, median of
11 after 3 warm calls.

Run on the card: ``python -m repro_torch.benchmarks.bench_throughput
[--out PATH]``; ``--device cpu`` off the GPU.  It writes a file only with
``--out`` (never ``BENCH_*.json``).
"""
from __future__ import annotations

import argparse

import torch

from ..core import PRNGKey, path_keys, sdeint
from ..device import resolve_device
from .bench_serving import ou_term, term_args
from .common import check_out, device_record, emit, time_fn, write_out

__all__ = ["run"]

SOLVERS = ("ees25", "reversible_heun")
BATCH_SIZES = (16, 64, 256, 1024)
N_STEPS = 64
DIM = 16


def run(*, device=None, batch_sizes=BATCH_SIZES, solvers=SOLVERS,
        n_steps: int = N_STEPS, dim: int = DIM, warmup: int = 3,
        iters: int = 11) -> dict:
    device = resolve_device(device)
    term, args = ou_term(), term_args(device)
    y0 = torch.ones(dim, device=device)
    records = []
    for solver in solvers:
        for batch in batch_sizes:
            keys = path_keys(PRNGKey(0, device=device), batch)

            def solve(bulk, solver=solver, keys=keys):
                with torch.no_grad():
                    return sdeint(term, solver, 0.0, 1.0, n_steps, y0,
                                  args=args, batch_keys=keys,
                                  bulk_increments=bulk, device=device).y_final

            us = time_fn(lambda: solve(True), device, warmup=warmup, iters=iters)
            us_per_step = time_fn(lambda: solve(False), device, warmup=warmup,
                                  iters=iters)
            traj_per_sec = batch / (us * 1e-6)
            records.append({
                "solver": solver, "batch_size": batch, "n_steps": n_steps,
                "dim": dim, "us_per_call": us, "traj_per_sec": traj_per_sec,
                "steps_per_sec": traj_per_sec * n_steps,
                "us_per_call_per_step_noise": us_per_step,
                "speedup_bulk": us_per_step / us,
            })
            emit(f"bench_throughput/{solver}/B{batch}", us,
                 f"traj_per_sec={traj_per_sec:.0f} "
                 f"speedup_bulk={us_per_step / us:.2f}")
    return {"device": device_record(device), "records": records}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="write the JSON payload here")
    a = ap.parse_args(argv)
    check_out(a.out)
    payload = run(device=a.device)
    write_out(a.out, payload)


if __name__ == "__main__":
    main()
