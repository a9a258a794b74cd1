"""Fused-vs-unfused step-kernel benchmark (port of
``benchmarks/bench_step_kernels.py``).

Times the solve hot loop — :func:`~repro_torch.core.sdeint.sdeint` over
``N_STEPS`` steps — with the fused :mod:`repro_torch.kernels.sde_step` route
on (``use_kernels=True``) and off, per noise mode x solver x batch size, on
the reference's three terms: an OU drift ``nu*(mu - y)`` with

* ``"diagonal"`` — diffusion ``sigma*cos(y)``;
* ``"prediffused"`` — diffusion ``sigma*ones_like(y)`` declared
  ``"additive"``, so the full-adjoint solve hoists ``g*dW`` out of the loop
  and the stages run the prediffused kernels;
* ``"general"`` — diffusion ``sigma*stack([ones_like(y)] * N_CHANNELS, -1)``,
  ``N_CHANNELS`` driving channels.

State width ``DIM``, args ``nu=0.2, mu=0.1, sigma=0.8``.  It prints one CSV
row per record (``name,us_per_call,derived``) and writes no file.  Times are
host wall clock around work that ends in a device synchronize, median of
``--iters``.

Run on the card: ``python -m repro_torch.benchmarks.step_kernels``; here:
``--device cpu`` (then the fused route is the kernels' plain twins, and the
times are the CPU's).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import torch

from ..core import PRNGKey, SDETerm, get_solver, path_keys, sdeint
from ..device import resolve_device

__all__ = ["SOLVERS", "NOISES", "N_STEPS", "DIM", "N_CHANNELS", "make_term",
           "term_args", "noise_shape", "run"]

SOLVERS = ("ees25", "ees27", "reversible_heun")
NOISES = ("diagonal", "general", "prediffused")
BATCH_SIZES = (64, 1024, 65536)
N_STEPS = 64
DIM = 16
N_CHANNELS = 4  # general-noise driving channels
ARGS = {"nu": 0.2, "mu": 0.1, "sigma": 0.8}


def _drift(t, y, a):
    return a["nu"] * (a["mu"] - y)


def make_term(noise: str) -> SDETerm:
    """The reference benchmark's term for ``noise`` (``"prediffused"`` is
    the additive term whose solves take the prediffused route)."""
    if noise == "diagonal":
        return SDETerm(drift=_drift,
                       diffusion=lambda t, y, a: a["sigma"] * torch.cos(y),
                       noise="diagonal")
    if noise == "prediffused":
        return SDETerm(drift=_drift,
                       diffusion=lambda t, y, a: a["sigma"] * torch.ones_like(y),
                       noise="additive")
    if noise == "general":
        return SDETerm(drift=_drift,
                       diffusion=lambda t, y, a: a["sigma"] * torch.stack(
                           [torch.ones_like(y)] * N_CHANNELS, dim=-1),
                       noise="general")
    raise ValueError(f"unknown noise {noise!r}; valid: {', '.join(NOISES)}")


def term_args(device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``{nu, mu, sigma}`` as scalar tensors on ``device``."""
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in ARGS.items()}


def noise_shape(noise: str, dim: int = DIM):
    """The Brownian increment's shape per path."""
    return (N_CHANNELS,) if noise == "general" else (dim,)


def _median_us(fn, device, warmup: int, iters: int) -> float:
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - start)
    times.sort()
    return times[len(times) // 2] * 1e6


def run(*, device=None, batch_sizes=BATCH_SIZES, solvers=SOLVERS,
        noises=NOISES, n_steps: int = N_STEPS, dim: int = DIM,
        warmup: int = 2, iters: int = 5):
    """Time every (noise, solver, batch) cell fused and unfused; returns
    the records and prints one CSV row each."""
    device = resolve_device(device)
    args = term_args(device)
    y0 = torch.ones(dim, device=device)
    records = []
    for noise in noises:
        term = make_term(noise)
        for spec in solvers:
            for batch in batch_sizes:
                keys = path_keys(PRNGKey(0, device=device), batch)

                def solve(use_kernels):
                    solver = get_solver(spec, use_kernels=use_kernels)
                    with torch.no_grad():
                        return sdeint(term, solver, 0.0, 1.0, n_steps, y0,
                                      args=args, batch_keys=keys,
                                      noise_shape=noise_shape(noise, dim),
                                      device=device).y_final

                us_unfused = _median_us(lambda: solve(False), device, warmup,
                                        iters)
                us_fused = _median_us(lambda: solve(True), device, warmup,
                                      iters)
                rec = {"solver": spec, "noise": noise, "batch_size": batch,
                       "n_steps": n_steps, "dim": dim,
                       "us_per_call_unfused": us_unfused,
                       "us_per_call_fused": us_fused,
                       "steps_per_sec_fused": batch * n_steps / (us_fused * 1e-6),
                       "speedup_fused": us_unfused / us_fused}
                records.append(rec)
                print(f"step_kernels/{spec}/{noise}/B{batch},{us_fused:.1f},"
                      f"unfused_us={us_unfused:.1f} "
                      f"speedup_fused={rec['speedup_fused']:.3f}", flush=True)
    return records


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch-sizes", default=",".join(map(str, BATCH_SIZES)))
    ap.add_argument("--n-steps", type=int, default=N_STEPS)
    ap.add_argument("--iters", type=int, default=5)
    ns = ap.parse_args()
    device = resolve_device(ns.device)
    if device.type == "cuda":
        print(f"# {torch.cuda.get_device_name(device)}", flush=True)
    run(device=device, n_steps=ns.n_steps, iters=ns.iters,
        batch_sizes=tuple(int(b) for b in ns.batch_sizes.split(",")))


if __name__ == "__main__":
    main()
