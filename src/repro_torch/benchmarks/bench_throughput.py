"""Monte-Carlo sampling throughput: trajectories/s against batch size.

Port of ``benchmarks/bench_throughput.py``: its single-device ladder and its
mesh ladder (:func:`run_mesh_ladder`).  Times the batched
``sdeint`` fan-out — the serving engine's hot path — for each solver and
batch size on the reference's OU term, with bulk Brownian increments (the
default) and again with per-step increments (``bulk_increments=False``), so
each record carries its own ``speedup_bulk``::

    {"solver": "ees25", "batch_size": 256, "n_steps": 64, "traj_per_sec": ...,
     "steps_per_sec": ..., "us_per_call": ..., "us_per_call_per_step_noise":
     ..., "speedup_bulk": ...}

Times are host wall clock per call ending in a device synchronize, median of
11 after 3 warm calls.  ``mesh_records`` repeats the ladder sharded over the
ranks of the world (``sdeint(..., mesh=make_sample_mesh(), mesh_axis="mc")``,
batch sizes the world divides; a world of one when the caller started
none), each record marked with its ``world_size`` and its speedup against
the single-device record.

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
from .common import check_out, device_record, emit, process_world, time_fn, write_out

__all__ = ["run", "run_mesh_ladder"]

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
    with process_world(device):
        mesh_records = run_mesh_ladder(term, args, y0, records, device=device,
                                       batch_sizes=batch_sizes, solvers=solvers,
                                       n_steps=n_steps, dim=dim, warmup=warmup,
                                       iters=iters)
    return {"device": device_record(device), "records": records,
            "mesh_records": mesh_records}


def run_mesh_ladder(term, args, y0, single_records, *, device, batch_sizes, solvers,
                    n_steps, dim, warmup: int = 3, iters: int = 11) -> list:
    """The same ladder sharded over every rank of the initialised world
    (batch sizes it divides): the same samples as the single-device ladder,
    as paths are keyed, only the wall clock changes."""
    from ..launch.mesh import make_sample_mesh

    mesh = make_sample_mesh(device=device)
    world = mesh.size()
    single_us = {(r["solver"], r["batch_size"]): r["us_per_call"] for r in single_records}
    records = []
    for solver in solvers:
        for batch in batch_sizes:
            if batch % world != 0:
                continue  # the axis must divide the batch
            keys = path_keys(PRNGKey(0, device=device), batch)

            def solve(solver=solver, keys=keys):
                with torch.no_grad():
                    return sdeint(term, solver, 0.0, 1.0, n_steps, y0, args=args,
                                  batch_keys=keys, mesh=mesh, mesh_axis="mc",
                                  device=device).y_final

            us = time_fn(solve, device, warmup=warmup, iters=iters)
            traj_per_sec = batch / (us * 1e-6)
            ref = single_us.get((solver, batch))
            records.append({
                "solver": solver, "batch_size": batch, "n_steps": n_steps, "dim": dim,
                "world_size": world, "us_per_call": us, "traj_per_sec": traj_per_sec,
                "steps_per_sec": traj_per_sec * n_steps,
                "speedup_vs_single": None if ref is None else ref / us,
            })
            emit(f"bench_throughput/{solver}/B{batch}/mesh{world}", us,
                 f"traj_per_sec={traj_per_sec:.0f}")
    return records


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
