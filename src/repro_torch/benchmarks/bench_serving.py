"""Serving-core throughput: paths/s and host dispatches against queue depth,
slots and ticks per dispatch.

Port of ``benchmarks/bench_serving.py``.  Drives a real
:class:`~repro_torch.serving.SDESampleEngine` (scheduler + executor, not a
bare ``sdeint``) over a queue of ``queue_depth`` same-signature requests of
``slots`` paths each (one engine tick per request) on the reference's OU
term, at each ``ticks_per_dispatch``, and records per configuration::

    {"queue_depth": 8, "slots": 64, "ticks_per_dispatch": 4, "n_ticks": 8,
     "host_dispatches": 2, "dispatches_per_tick": 0.25,
     "requests_per_sec": ..., "paths_per_sec": ..., "us_per_tick": ...}

Every configuration is served twice and only the second (warm) pass is
timed: host wall clock over ``run()``, which ends with the results on the
host.  Samples are the same at every depth (tested in
``tests/test_torch_serving.py``); the sweep prices dispatch only.

Run on the card: ``python -m repro_torch.benchmarks.bench_serving
[--slots 64,65536] [--depths 4,8,16] [--ticks-per-dispatch 1,4,16]
[--out PATH]``; ``--device cpu`` off the GPU.  It writes a
file only with ``--out`` (never ``BENCH_*.json``).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import SDETerm
from ..device import resolve_device
from ..serving import SDESampleConfig, SDESampleEngine
from .common import check_out, device_record, emit, write_out

__all__ = ["ou_term", "term_args", "serve_queue", "run"]

SLOTS = (64,)
QUEUE_DEPTHS = (4, 8, 16)
TICKS_PER_DISPATCH = (1, 4, 16)
N_STEPS = 64
DIM = 16
SOLVER = "ees25"


def ou_term() -> SDETerm:
    """The reference benchmark's OU term: drift ``nu*(mu - y)``, diagonal
    diffusion ``sigma``."""
    return SDETerm(
        drift=lambda t, y, a: a["nu"] * (a["mu"] - y),
        diffusion=lambda t, y, a: a["sigma"] * torch.ones_like(y),
        noise="diagonal",
    )


def term_args(device) -> dict:
    """``{nu: 0.2, mu: 0.1, sigma: 2.0}`` as float32 scalars on ``device``."""
    return {k: torch.tensor(v, device=device)
            for k, v in (("nu", 0.2), ("mu", 0.1), ("sigma", 2.0))}


def serve_queue(term, args, y0, *, depth: int, slots: int, tpd: int,
                n_steps: int, solver: str, device):
    """Serve ``depth`` requests of ``slots`` paths twice; returns (the warm
    pass's seconds, engine)."""
    eng = SDESampleEngine(
        term, y0, SDESampleConfig(slots=slots, ticks_per_dispatch=tpd),
        args=args, device=device)

    def one_pass():
        for i in range(depth):
            eng.submit(solver, t1=1.0, n_steps=n_steps, n_paths=slots, seed=i)
        start = time.perf_counter()
        eng.run()
        return time.perf_counter() - start

    one_pass()  # warm: libraries, callables, allocator
    return one_pass(), eng


def run(*, device=None, slots=SLOTS, depths=QUEUE_DEPTHS,
        ticks_per_dispatch=TICKS_PER_DISPATCH, n_steps: int = N_STEPS,
        dim: int = DIM, solver: str = SOLVER) -> dict:
    device = resolve_device(device)
    term, args = ou_term(), term_args(device)
    y0 = torch.ones(dim, device=device)
    records = []
    for n_slots in slots:
        for depth in depths:
            for tpd in ticks_per_dispatch:
                if tpd > depth:
                    continue  # a stack deeper than the queue adds nothing
                secs, eng = serve_queue(term, args, y0, depth=depth,
                                        slots=n_slots, tpd=tpd,
                                        n_steps=n_steps, solver=solver,
                                        device=device)
                # The counters cover both passes; each served `depth` ticks.
                n_ticks = eng.executor.n_ticks // 2
                dispatches = eng.executor.n_dispatches // 2
                records.append({
                    "solver": solver, "queue_depth": depth, "slots": n_slots,
                    "ticks_per_dispatch": tpd, "n_steps": n_steps, "dim": dim,
                    "n_ticks": n_ticks, "host_dispatches": dispatches,
                    "dispatches_per_tick": dispatches / n_ticks,
                    "seconds": secs, "requests_per_sec": depth / secs,
                    "paths_per_sec": depth * n_slots / secs,
                    "us_per_tick": secs * 1e6 / n_ticks,
                })
                emit(f"bench_serving/D{depth}/S{n_slots}/T{tpd}",
                     secs * 1e6 / n_ticks,
                     f"paths_per_sec={depth * n_slots / secs:.0f} "
                     f"dispatches={dispatches}/{n_ticks}")
    return {"device": device_record(device), "records": records}


def _ints(text: str):
    return tuple(int(x) for x in text.split(","))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="write the JSON payload here")
    ap.add_argument("--slots", default=",".join(map(str, SLOTS)))
    ap.add_argument("--depths", default=",".join(map(str, QUEUE_DEPTHS)))
    ap.add_argument("--ticks-per-dispatch",
                    default=",".join(map(str, TICKS_PER_DISPATCH)))
    ap.add_argument("--n-steps", type=int, default=N_STEPS)
    ap.add_argument("--dim", type=int, default=DIM)
    a = ap.parse_args(argv)
    check_out(a.out)
    payload = run(device=a.device, slots=_ints(a.slots), depths=_ints(a.depths),
                  ticks_per_dispatch=_ints(a.ticks_per_dispatch),
                  n_steps=a.n_steps, dim=a.dim)
    write_out(a.out, payload)


if __name__ == "__main__":
    main()
