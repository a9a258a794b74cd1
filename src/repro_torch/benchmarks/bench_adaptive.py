"""Adaptive vs fixed-grid solves: steps saved at matched strong error.

Port of ``benchmarks/bench_adaptive.py``, at its sizes (64 paths of
dimension 4, ``T = 2``, float64, the stiff-transient OU term): integrates
the batch with the PI-controlled EES(2,5) stepper on one Virtual Brownian
Tree per path across a sweep of tolerances, and against fixed uniform grids
*on the same trees*, so strong error is measured path by path against one
fine (8192-step) reference.  Records:

* per tolerance: mean accepted / rejected steps, strong error, and accepted
  steps per second through the forward-only (``bounded=False``) stepper
  (median host wall clock of 3 calls after one warm call, each ended by a
  device synchronize);
* per fixed grid: steps and strong error;
* ``matched_fixed_steps`` / ``steps_saved_ratio``: the fixed grid that
  matches each tolerance's error (log-log interpolation), over the
  adaptive trials taken.

Run on the card: ``python -m repro_torch.benchmarks.bench_adaptive
[--out PATH]``; ``--device cpu`` off the GPU.  It writes a file only with
``--out`` (never ``BENCH_*.json``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import (PRNGKey, SDETerm, TimeGrid, get_solver, integrate_adaptive, solve,
                    split, virtual_brownian_tree)
from ..device import resolve_device
from .common import check_out, device_record, emit, synchronize, time_fn, write_out

__all__ = ["transient_term", "transient_args", "run"]

RTOLS = (1e-2, 3e-3, 1e-3, 3e-4)
FIXED_STEPS = (8, 16, 32, 64, 128, 256, 512)
N_PATHS = 64
DIM = 4
T1 = 2.0
REF_STEPS = 8192
MAX_STEPS = 512


def transient_term() -> SDETerm:
    """Mean reversion whose rate spikes 40x in a window of width ~0.08
    around t = 1: a uniform grid must resolve the spike everywhere, the
    controller only inside it.  ``t`` may be one time per path."""
    def rate(t, a):
        return a["nu"] * (1.0 + 40.0 * torch.exp(-(((t - 1.0) / 0.08) ** 2)))

    return SDETerm(
        drift=lambda t, y, a: rate(t, a) * (a["mu"] - y),
        diffusion=lambda t, y, a: a["sigma"] * (1.0 + 0.1 * torch.tanh(y)),
        noise="diagonal",
    )


def transient_args(device, requires_grad: bool = False) -> dict:
    """``{nu: 0.7, mu: 0.2, sigma: 0.4}`` as float64 scalars."""
    return {k: torch.tensor(v, dtype=torch.float64, device=device,
                            requires_grad=requires_grad)
            for k, v in (("nu", 0.7), ("mu", 0.2), ("sigma", 0.4))}


def run(*, device=None, n_paths: int = N_PATHS, rtols=RTOLS,
        fixed_steps=FIXED_STEPS, ref_steps: int = REF_STEPS,
        max_steps: int = MAX_STEPS) -> dict:
    device = resolve_device(device)
    term, args = transient_term(), transient_args(device)
    y0 = torch.ones(n_paths, DIM, dtype=torch.float64, device=device)
    tree = virtual_brownian_tree(split(PRNGKey(0, device=device), n_paths),
                                 0.0, T1, shape=(DIM,), dtype=torch.float64,
                                 tol=T1 * 2.0 ** -14)
    solver = get_solver("ees25")

    def fixed(n):
        grid = TimeGrid.uniform(0.0, T1, n, tree)
        return solve(solver, term, y0, grid, args, batch_dims=1).y_final

    with torch.no_grad():
        ref = fixed(ref_steps)

        def strong_err(y):
            return float(torch.sqrt(((y - ref) ** 2).sum(-1).mean()))

        records = {"adaptive": [], "fixed": []}
        for n in fixed_steps:
            err = strong_err(fixed(n))
            records["fixed"].append({"n_steps": n, "strong_err": err})
            emit(f"bench_adaptive/fixed/N{n}", 0.0, f"strong_err={err:.3e}")

        for rtol in rtols:
            def batch(rtol=rtol):
                return integrate_adaptive(
                    solver, term, y0, tree, args, rtol=rtol, atol=rtol * 1e-2,
                    max_steps=max_steps, bounded=False)

            out = batch()
            synchronize(device)
            err = strong_err(out.y_final)
            acc = float(out.n_accepted.double().mean())
            rej = float(out.n_rejected.double().mean())
            us = time_fn(batch, device, warmup=1, iters=3)
            records["adaptive"].append({
                "rtol": rtol, "mean_accepted": acc, "mean_rejected": rej,
                "strong_err": err, "us_per_batch": us,
                "accepted_steps_per_sec": acc * n_paths / (us * 1e-6),
            })
            emit(f"bench_adaptive/rtol{rtol:g}", us,
                 f"acc={acc:.1f},rej={rej:.1f},strong_err={err:.3e}")

    # Steps saved: the fixed grid whose error matches each tolerance's.
    fx_n = np.array([r["n_steps"] for r in records["fixed"]], float)
    fx_e = np.array([r["strong_err"] for r in records["fixed"]], float)
    for rec in records["adaptive"]:
        matched = float(np.exp(np.interp(
            np.log(rec["strong_err"]), np.log(fx_e[::-1]), np.log(fx_n[::-1]))))
        rec["matched_fixed_steps"] = matched
        rec["steps_saved_ratio"] = matched / max(
            rec["mean_accepted"] + rec["mean_rejected"], 1.0)
        emit(f"bench_adaptive/saved/rtol{rec['rtol']:g}", 0.0,
             f"matched_fixed={matched:.1f},ratio={rec['steps_saved_ratio']:.2f}")
    return {"device": device_record(device), "n_paths": n_paths, "dim": DIM,
            "t1": T1, "ref_steps": ref_steps, "records": records}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="write the JSON payload here")
    a = ap.parse_args(argv)
    check_out(a.out)
    write_out(a.out, run(device=a.device))


if __name__ == "__main__":
    main()
