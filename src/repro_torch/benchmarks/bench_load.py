"""Async serving-plane load test: latency percentiles under Poisson arrivals.

Port of ``benchmarks/bench_load.py``, at its sizes (32 slots, 4 ticks a
dispatch, 40 requests at 50 requests/s, seed 0, the OU term of
:mod:`.bench_serving` at dimension 16, float32).  The population mixes
fixed-grid solves with an adaptive one (``"ees25:adaptive"``, rtol 1e-3,
a 128-trial budget), which needs the port's adaptive serving:

* **load** — every signature served once (warm), then ``--requests``
  arrivals with exponential gaps at ``--rate`` (``random.Random(seed)``: the
  arrival pattern and the mix), each client timing ``submit`` to a result
  on the device: ``p50_ms`` / ``p99_ms``; then the same mix submitted at
  once and drained: ``saturation_rps``; and ``dispatches_per_tick`` over the
  measured phases;
* **bucketing** — twelve signatures sharing one step size (two solvers x
  six horizons), drained from cold with coalescing on and off:
  ``n_executables`` (the executor's cached callables), saturation rps of
  each, and the seconds of ``warmup`` into an empty and then a filled
  ``compile_cache_dir`` (the kernel libraries' directory; these plain
  specs build none, so both stay small).

Run on the card: ``python -m repro_torch.benchmarks.bench_load [--out PATH]
[--requests N] [--rate RPS] [--slots N] [--ticks-per-dispatch N] [--seed S]
[--skip-bucketing]``; ``--device cpu`` off the GPU.  It writes a file only
with ``--out`` (never ``BENCH_*.json``).
"""
from __future__ import annotations

import argparse
import asyncio
import random
import tempfile
import time

import torch

from ..device import resolve_device
from ..serving import AsyncSDESampleEngine, SDESampleConfig, SDESampleEngine
from .bench_serving import ou_term, term_args
from .common import check_out, device_record, emit, percentile, write_out

__all__ = ["POPULATION", "run", "run_bucketing"]

SLOTS = 32
TICKS_PER_DISPATCH = 4
N_REQUESTS = 40
RATE = 50.0
SEED = 0
DIM = 16

# Mixed signature population: solver x horizon x tolerance, weighted toward
# the cheap fixed-grid solve.
POPULATION = (
    {"name": "ees25/short", "weight": 4, "solver": "ees25",
     "kw": dict(t1=1.0, n_steps=32)},
    {"name": "ees25/long", "weight": 2, "solver": "ees25",
     "kw": dict(t1=2.0, n_steps=64)},
    {"name": "heun/short", "weight": 2, "solver": "heun",
     "kw": dict(t1=1.0, n_steps=32)},
    {"name": "ees25/adaptive", "weight": 1, "solver": "ees25:adaptive",
     "kw": dict(t1=1.0, n_steps=128, rtol=1e-3)},
)
# Twelve signatures sharing h = 1/32, on four buckets (per solver: 24, 32 ->
# rung 32; 40, 48, 56, 64 -> rung 64).
BUCKET_SOLVERS = ("ees25", "heun")
BUCKET_HORIZON_STEPS = (24, 32, 40, 48, 56, 64)


def _bucket_specs():
    return [{"solver": s, "t1": n / 32.0, "n_steps": n}
            for s in BUCKET_SOLVERS for n in BUCKET_HORIZON_STEPS]


def _draw_mix(rng: random.Random, n: int):
    choices = [s for s in POPULATION for _ in range(s["weight"])]
    return [rng.choice(choices) for _ in range(n)]


def _engine(slots: int, tpd: int, device, **cfg):
    return AsyncSDESampleEngine(
        ou_term(), torch.ones(DIM, device=device),
        SDESampleConfig(slots=slots, ticks_per_dispatch=tpd,
                        max_queue_paths=64 * slots, **cfg),
        args=term_args(device), device=device)


async def _load(slots, tpd, n_requests, rate, seed, device):
    rng = random.Random(seed)
    mix = _draw_mix(rng, n_requests)
    async with _engine(slots, tpd, device) as eng:
        for spec in POPULATION:  # warm: kernel libraries, callables
            await eng.result(await eng.submit(spec["solver"], n_paths=slots,
                                              seed=0, **spec["kw"]))
        d0, t0 = eng.executor.n_dispatches, eng.executor.n_ticks
        latencies = []

        async def client(k, spec):
            start = time.perf_counter()
            rid = await eng.submit(spec["solver"], n_paths=slots, seed=k,
                                   **spec["kw"])
            await eng.result(rid)
            latencies.append(time.perf_counter() - start)

        tasks = []
        for k, spec in enumerate(mix):
            await asyncio.sleep(rng.expovariate(rate))
            tasks.append(asyncio.create_task(client(k, spec)))
        await asyncio.gather(*tasks)
        start = time.perf_counter()
        rids = [await eng.submit(spec["solver"], n_paths=slots, seed=k,
                                 **spec["kw"]) for k, spec in enumerate(mix)]
        for rid in rids:
            await eng.result(rid)
        saturation = len(mix) / (time.perf_counter() - start)
        d1, t1 = eng.executor.n_dispatches, eng.executor.n_ticks
    lat = sorted(latencies)
    return {
        "slots": slots, "ticks_per_dispatch": tpd, "n_requests": n_requests,
        "offered_rps": rate, "seed": seed,
        "mix": sorted({s["name"] for s in mix}),
        "p50_ms": percentile(lat, 0.50) * 1e3,
        "p99_ms": percentile(lat, 0.99) * 1e3,
        "saturation_rps": saturation,
        "dispatches_per_tick": (d1 - d0) / max(1, t1 - t0),
    }


async def _bucket_drain(bucketing: bool, slots: int, device):
    """Cold drain of the mixed-horizon population: (rps, callables,
    buckets seen)."""
    specs = _bucket_specs()
    start = time.perf_counter()
    async with _engine(slots, 1, device, bucketing=bucketing) as eng:
        rids = [await eng.submit(s["solver"], t1=s["t1"], n_steps=s["n_steps"],
                                 n_paths=slots, seed=k) for k, s in enumerate(specs)]
        results = [await eng.result(rid) for rid in rids]
        secs = time.perf_counter() - start
        n_exec = len(eng.executor._callables)
    buckets = {r.bucket for r in results if r.bucket is not None}
    return len(specs) / secs, n_exec, len(buckets)


def _bucket_warmup_seconds(slots: int, device):
    """Seconds of ``warmup`` of the population into an empty, then a
    filled, ``compile_cache_dir`` (each a fresh engine)."""
    with tempfile.TemporaryDirectory() as cache_dir:
        def timed():
            eng = SDESampleEngine(ou_term(), torch.ones(DIM, device=device),
                                  SDESampleConfig(slots=slots, ticks_per_dispatch=1,
                                                  compile_cache_dir=cache_dir),
                                  args=term_args(device), device=device)
            start = time.perf_counter()
            eng.warmup(_bucket_specs())
            return time.perf_counter() - start

        return timed(), timed()


def run(*, device=None, slots: int = SLOTS, tpd: int = TICKS_PER_DISPATCH,
        n_requests: int = N_REQUESTS, rate: float = RATE,
        seed: int = SEED) -> dict:
    device = resolve_device(device)
    load = asyncio.run(_load(slots, tpd, n_requests, rate, seed, device))
    emit(f"bench_load/R{n_requests}/S{slots}/T{tpd}", load["p50_ms"] * 1e3,
         f"p99_ms={load['p99_ms']:.1f} sat_rps={load['saturation_rps']:.1f} "
         f"dpt={load['dispatches_per_tick']:.3f}")
    return {"device": device_record(device), "load": load}


def run_bucketing(*, device=None, slots: int = SLOTS) -> dict:
    device = resolve_device(device)
    rps_on, exec_on, n_buckets = asyncio.run(_bucket_drain(True, slots, device))
    rps_off, exec_off, _ = asyncio.run(_bucket_drain(False, slots, device))
    cold_s, warm_s = _bucket_warmup_seconds(slots, device)
    section = {
        "slots": slots, "n_signatures": len(_bucket_specs()),
        "n_buckets": n_buckets, "n_executables_bucketed": exec_on,
        "n_executables_unbucketed": exec_off,
        "saturation_rps_bucketed": rps_on, "saturation_rps_unbucketed": rps_off,
        "speedup_bucketed": rps_on / rps_off,
        "cold_compile_s": cold_s, "warm_compile_s": warm_s,
    }
    emit(f"bench_load/bucketing/S{slots}", 1e6 / rps_on,
         f"exec {exec_on}/{exec_off} rps {rps_on:.1f}/{rps_off:.1f} "
         f"speedup={section['speedup_bucketed']:.2f} "
         f"warmup cold={cold_s:.3f}s warm={warm_s:.3f}s")
    return section


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="write the JSON payload here")
    ap.add_argument("--slots", type=int, default=SLOTS)
    ap.add_argument("--ticks-per-dispatch", type=int, default=TICKS_PER_DISPATCH)
    ap.add_argument("--requests", type=int, default=N_REQUESTS)
    ap.add_argument("--rate", type=float, default=RATE)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--skip-bucketing", action="store_true",
                    help="skip the mixed-horizon coalescing sweep")
    a = ap.parse_args(argv)
    check_out(a.out)
    payload = run(device=a.device, slots=a.slots, tpd=a.ticks_per_dispatch,
                  n_requests=a.requests, rate=a.rate, seed=a.seed)
    if not a.skip_bucketing:
        payload["bucketing"] = run_bucketing(device=a.device, slots=a.slots)
    write_out(a.out, payload)


if __name__ == "__main__":
    main()
