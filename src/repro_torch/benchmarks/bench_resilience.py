"""Resilience benchmark: the guard's overhead and goodput under faults.

Port of ``benchmarks/bench_resilience.py``, its three sections:

* **guard_overhead** — the blow-up guard is on by default in every serving
  drain, so its cost on *clean* traffic is the tax every request pays.  The
  same queue is drained by a sync engine with the guard and the retry policy
  and by one with neither (``guard_threshold=None, retry_policy=None``),
  passes interleaved, best of ``--reps`` each, warm.
* **serving** — closed-loop async drains of one request mix (two horizons
  of one solver), clean and under a seeded NaN-injection schedule
  (:func:`repro_torch.serving.inject_faults` at ``--nan-rate``).  Faulted
  requests retry down the degradation ladder, so every request completes;
  what degrades is **goodput** (completed requests per second) and
  latency.  Records ``goodput_clean`` / ``goodput_faulty`` (best of 3
  passes each, alternating), p50/p99 latency of each (host wall clock from
  submit to a result on the device, over the 3 passes' requests) and the
  engine's retry and divergence counters.
* **trainer** — :func:`repro_torch.train.resilient_train_loop` on the OU
  term (float32, 8 paths, 32 steps) under a deterministic fault schedule:
  a 3-step NaN streak every 7 steps, long enough to trip the default
  ``skip_patience = 3`` rollback each cycle.  Records skips, rollbacks,
  goodput (productive / total steps), the final loss and the seconds.

The sizes are the reference's (8 slots, 8 requests, 1024 steps; 4096 steps
for the overhead drains; dimension 16, NaN rate 0.3, seed 0; 21 training
steps).  ``--check`` applies the reference's gates: every field finite,
clean goodput at least the faulty one, injected NaNs and retries seen,
overhead below 5%, every blown batch skipped, at least one rollback and a
training goodput strictly between 0 and 1.

Run on the card: ``python -m repro_torch.benchmarks.bench_resilience
[--reps N] [--out PATH] [--check]``; ``--device cpu`` off the GPU.  It
writes a file only with ``--out`` (never ``BENCH_*.json``).
"""
from __future__ import annotations

import argparse
import asyncio
import math
import time

import torch

from ..device import resolve_device
from ..serving import (AsyncSDESampleEngine, FaultConfig, SDESampleConfig,
                       SDESampleEngine, inject_faults)
from .bench_serving import ou_term, term_args
from .common import check_out, device_record, emit, percentile, write_out

__all__ = ["run_guard_overhead", "run_serving", "run_trainer", "run", "check"]

SLOTS = 8
N_REQUESTS = 8
N_STEPS = 1024
# Guarded and unguarded solves run different code; at 4096 steps the step
# loop dominates the per-drain fixed costs (the reference's choice).
GUARD_N_STEPS = 4096
DIM = 16
SOLVER = "ees25"
NAN_RATE = 0.3
SEED = 0
REPS = 5
PASSES = 3
TRAIN_STEPS = 21


# ---------------------------------------------------------------- section 1

def _drain_pass(eng, *, requests: int, slots: int, n_steps: int) -> float:
    for i in range(requests):
        eng.submit(SOLVER, t1=1.0, n_steps=n_steps, n_paths=slots, seed=i)
    start = time.perf_counter()
    eng.run()  # ends with the results on the host
    return time.perf_counter() - start


def run_guard_overhead(*, device=None, slots: int = SLOTS,
                       requests: int = N_REQUESTS, n_steps: int = GUARD_N_STEPS,
                       dim: int = DIM, reps: int = REPS) -> dict:
    device = resolve_device(device)
    y0 = torch.ones(dim, device=device)
    args = term_args(device)
    eng_on = SDESampleEngine(ou_term(), y0, SDESampleConfig(slots=slots),
                             args=args, device=device)
    eng_off = SDESampleEngine(
        ou_term(), y0,
        SDESampleConfig(slots=slots, guard_threshold=None, retry_policy=None),
        args=args, device=device)
    kw = dict(requests=requests, slots=slots, n_steps=n_steps)
    _drain_pass(eng_on, **kw)  # warm
    _drain_pass(eng_off, **kw)
    ts_on, ts_off = [], []
    for _ in range(reps):  # interleaved, so drift hits both alike
        ts_on.append(_drain_pass(eng_on, **kw))
        ts_off.append(_drain_pass(eng_off, **kw))
    on, off = min(ts_on), min(ts_off)
    frac = on / off - 1.0
    emit(f"bench_resilience/guard/S{slots}/N{n_steps}", on * 1e6,
         f"overhead_frac={frac:+.4f}")
    return {"slots": slots, "requests": requests, "n_steps": n_steps,
            "reps": reps, "secs_guarded": on, "secs_unguarded": off,
            "guard_overhead_frac": frac}


# ---------------------------------------------------------------- section 2

def _request_mix(requests: int, n_steps: int):
    # Two horizons of one solver: co-batching without many callables.
    return [dict(t1=1.0 if k % 2 == 0 else 2.0, n_steps=n_steps)
            for k in range(requests)]


class _LoopHarness:
    """One async engine and its warm state, driven pass by pass.  With
    ``fault_cfg`` every pass runs under a fresh injector around the same
    clean executor, so each pass replays the same fault schedule."""

    def __init__(self, mix, *, slots: int, dim: int, device, fault_cfg=None):
        self.mix = mix
        self.slots = slots
        self.fault_cfg = fault_cfg
        self.latencies = []
        self.injector = None
        cfg = SDESampleConfig(slots=slots, max_queue_paths=64 * slots)
        self.eng = AsyncSDESampleEngine(
            ou_term(), torch.ones(dim, device=device), cfg,
            args=term_args(device), device=device)
        self._base_exec = None
        self._pass_no = 0

    async def warm(self):
        # Every signature of the mix and its first degradation (doubled
        # steps), then one full pass under the fault schedule: the measured
        # passes price guards and retries, not first dispatches.
        pairs = {(s["t1"], s["n_steps"]) for s in self.mix}
        pairs |= {(t1, n * 2) for t1, n in pairs}
        for t1, n in sorted(pairs):
            rid = await self.eng.submit(SOLVER, t1=t1, n_steps=n,
                                        n_paths=self.slots, seed=0)
            await self.eng.result(rid)
        self._base_exec = self.eng._eng.executor
        await self.run_pass(record=False)
        for c in self.eng._eng.counters:
            self.eng._eng.counters[c] = 0

    async def run_pass(self, record=True) -> float:
        self.eng._eng.executor = self._base_exec
        self.eng.executor = self._base_exec
        if self.fault_cfg:
            self.injector = inject_faults(self.eng, self.fault_cfg)
        seed0 = 1000 * self._pass_no
        self._pass_no += 1

        async def client(k, spec):
            start = time.perf_counter()
            rid = await self.eng.submit(SOLVER, n_paths=self.slots,
                                        seed=seed0 + k, **spec)
            await self.eng.result(rid)
            if record:
                self.latencies.append(time.perf_counter() - start)

        start = time.perf_counter()
        await asyncio.gather(*(client(k, s) for k, s in enumerate(self.mix)))
        return time.perf_counter() - start

    def summary(self, pass_secs) -> dict:
        lat = sorted(self.latencies)
        return {"goodput_rps": len(self.mix) / min(pass_secs),
                "p50_ms": percentile(lat, 0.50) * 1e3,
                "p99_ms": percentile(lat, 0.99) * 1e3,
                "n_latencies": len(lat),
                "counters": dict(self.eng._eng.counters),
                "n_injected_nans": self.injector.n_nans if self.injector else 0}


async def _clean_vs_faulty(mix, *, slots: int, dim: int, device, fault_cfg,
                           passes: int = PASSES):
    clean = _LoopHarness(mix, slots=slots, dim=dim, device=device)
    faulty = _LoopHarness(mix, slots=slots, dim=dim, device=device,
                          fault_cfg=fault_cfg)
    async with clean.eng, faulty.eng:
        await clean.warm()
        await faulty.warm()
        secs_c, secs_f = [], []
        for _ in range(passes):  # alternating, so drift hits both alike
            secs_c.append(await clean.run_pass())
            secs_f.append(await faulty.run_pass())
        return clean.summary(secs_c), faulty.summary(secs_f)


def run_serving(*, device=None, slots: int = SLOTS, requests: int = N_REQUESTS,
                n_steps: int = N_STEPS, dim: int = DIM,
                nan_rate: float = NAN_RATE, seed: int = SEED) -> dict:
    device = resolve_device(device)
    mix = _request_mix(requests, n_steps)
    clean, faulty = asyncio.run(_clean_vs_faulty(
        mix, slots=slots, dim=dim, device=device,
        fault_cfg=FaultConfig(seed=seed, nan_rate=nan_rate)))
    section = {
        "slots": slots, "requests": requests, "n_steps": n_steps,
        "nan_rate": nan_rate, "seed": seed,
        "goodput_clean": clean["goodput_rps"],
        "goodput_faulty": faulty["goodput_rps"],
        "p50_ms_clean": clean["p50_ms"], "p99_ms_clean": clean["p99_ms"],
        "p50_ms_faulty": faulty["p50_ms"], "p99_ms_faulty": faulty["p99_ms"],
        "n_latencies": faulty["n_latencies"],
        "n_injected_nans": faulty["n_injected_nans"],
        "retries": faulty["counters"]["retries"],
        "diverged_requests": faulty["counters"]["diverged_requests"],
        "diverged_paths": faulty["counters"]["diverged_paths"],
        "timeouts": faulty["counters"]["timeouts"],
        "clean_counters": clean["counters"],
    }
    emit(f"bench_resilience/faults/R{requests}/rate{nan_rate}",
         faulty["p99_ms"] * 1e3,
         f"goodput {clean['goodput_rps']:.1f}->{faulty['goodput_rps']:.1f} "
         f"p50_ms {clean['p50_ms']:.1f}/{faulty['p50_ms']:.1f} "
         f"retries={section['retries']} nans={section['n_injected_nans']}")
    return section


# ---------------------------------------------------------------- section 3

def run_trainer(*, device=None, train_steps: int = TRAIN_STEPS,
                dim: int = DIM) -> dict:
    import tempfile

    from ..core import prng
    from ..optim import adamw, cosine_schedule
    from ..train import ResilienceConfig, make_sde_train_step, resilient_train_loop
    from .bench_training import OUParams

    device = resolve_device(device)
    params = OUParams(device)
    optimizer = adamw(cosine_schedule(1e-3, 5, train_steps))
    opt_state = optimizer.init(list(params.parameters()))

    def loss(p, r):
        return torch.mean(r.y_final ** 2)

    common = dict(t0=0.0, t1=1.0, n_steps=32, n_paths=8, device=device)
    y0_fn = lambda p: torch.zeros(dim, device=device)  # noqa: E731
    clean_step = make_sde_train_step(SOLVER, ou_term(), optimizer, y0_fn, loss,
                                     **common)
    blown_step = make_sde_train_step(SOLVER, ou_term(), optimizer, y0_fn,
                                     lambda p, r: loss(p, r) * float("nan"),
                                     **common)
    # Deterministic fault schedule: a 3-step NaN streak every 7 steps.
    fault_steps = {s for s in range(train_steps) if s % 7 in (3, 4, 5)}
    counter = {"step": 0}

    def step_fn(p, s, key):
        step = counter["step"]
        counter["step"] += 1
        return (blown_step if step in fault_steps else clean_step)(p, s, key)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        out = resilient_train_loop(
            step_fn, params, opt_state, prng.PRNGKey(0, device=device),
            res=ResilienceConfig(steps=train_steps, ckpt_every=2,
                                 ckpt_dir=ckpt_dir))
        secs = time.perf_counter() - t0
    section = {
        "steps": train_steps,
        "fault_steps": sorted(fault_steps),
        "skips": int(sum(out["skipped"])),
        "rollbacks": out["rollbacks"],
        "goodput": out["goodput"],
        "final_loss": out["losses"][-1],
        "seconds": secs,
    }
    emit(f"bench_resilience/trainer/T{train_steps}", secs * 1e6 / train_steps,
         f"skips={section['skips']} rollbacks={section['rollbacks']} "
         f"goodput={section['goodput']:.2f}")
    return section


# ------------------------------------------------------------------ run all

def run(*, device=None, slots: int = SLOTS, requests: int = N_REQUESTS,
        n_steps: int = N_STEPS, dim: int = DIM, nan_rate: float = NAN_RATE,
        seed: int = SEED, reps: int = REPS, train_steps: int = TRAIN_STEPS,
        guard_n_steps: int = GUARD_N_STEPS) -> dict:
    device = resolve_device(device)
    return {
        "device": device_record(device),
        "guard_overhead": run_guard_overhead(
            device=device, slots=slots, requests=requests,
            n_steps=guard_n_steps, dim=dim, reps=reps),
        "serving": run_serving(device=device, slots=slots, requests=requests,
                               n_steps=n_steps, dim=dim, nan_rate=nan_rate,
                               seed=seed),
        "trainer": run_trainer(device=device, train_steps=train_steps, dim=dim),
    }


def check(data: dict) -> None:
    """The reference's gates for these two sections; raises AssertionError."""
    def finite(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                finite(v, f"{path}.{k}")
        elif isinstance(x, (int, float)):
            assert math.isfinite(x), f"non-finite field {path}={x}"

    finite({k: v for k, v in data.items() if k != "device"}, "bench")
    g = data["guard_overhead"]
    assert g["guard_overhead_frac"] < 0.05, (
        f"clean-traffic guard overhead {g['guard_overhead_frac']:.3f} >= 5%")
    s = data["serving"]
    assert s["goodput_clean"] >= s["goodput_faulty"], (
        f"faulty goodput {s['goodput_faulty']:.2f} beat clean "
        f"{s['goodput_clean']:.2f}: timing is broken")
    assert s["n_injected_nans"] > 0, "fault schedule injected nothing"
    assert s["retries"] > 0, "injected NaNs produced no retries"
    t = data["trainer"]
    assert t["skips"] == len(t["fault_steps"]), "guard missed a blown batch"
    assert t["rollbacks"] >= 1, "skip streak never tripped a rollback"
    assert 0 < t["goodput"] < 1, f"trainer goodput {t['goodput']} out of range"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="write the JSON payload here")
    ap.add_argument("--slots", type=int, default=SLOTS)
    ap.add_argument("--requests", type=int, default=N_REQUESTS)
    ap.add_argument("--n-steps", type=int, default=N_STEPS)
    ap.add_argument("--guard-n-steps", type=int, default=GUARD_N_STEPS)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--nan-rate", type=float, default=NAN_RATE)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS)
    ap.add_argument("--check", action="store_true",
                    help="apply the reference's gates to the fresh results")
    a = ap.parse_args(argv)
    check_out(a.out)
    data = run(device=a.device, slots=a.slots, requests=a.requests,
               n_steps=a.n_steps, dim=a.dim, nan_rate=a.nan_rate, seed=a.seed,
               reps=a.reps, train_steps=a.train_steps,
               guard_n_steps=a.guard_n_steps)
    write_out(a.out, data)
    if a.check:
        check(data)
        print("# bench_resilience gates passed", flush=True)


if __name__ == "__main__":
    main()
