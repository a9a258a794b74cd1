"""Reversible-adjoint training on adaptive grids: memory and wall clock.

Port of ``benchmarks/bench_reversible_adaptive.py``, at its sizes (32
paths of dimension 16, a 512-trial budget, rtol 1e-3, ``T = 2``, float64,
the stiff-transient term of :mod:`.bench_adaptive`): one loss-gradient
evaluation whose forward realizes each path's grid with the PI controller
on a Virtual Brownian Tree and whose backward runs the chosen adjoint over
the realized grids, for the full, recursive and reversible adjoints with
per-step increments and the reversible one with the bulk realization.
Records per configuration:

* ``peak_bytes`` — the card's peak allocated memory over the evaluation,
  above what was allocated before it (where the reference reads XLA's
  ``temp_bytes``); null off the card;
* ``us_per_step`` — median host wall clock of a gradient evaluation (3
  after the warm call that measured the memory, each ended by a device
  synchronize);
* ``grad_rel_err_vs_full`` — the largest relative gradient deviation from
  the full adjoint on the same realized grids.

Run on the card: ``python -m repro_torch.benchmarks.bench_reversible_adaptive
[--out PATH] [--max-steps N] [--paths B] [--dim D]``; ``--device cpu`` off
the GPU.  It writes a file only with ``--out`` (never ``BENCH_*.json``).
"""
from __future__ import annotations

import argparse

import torch

from ..core import PRNGKey, path_keys, sdeint
from ..device import resolve_device
from .bench_adaptive import transient_args, transient_term
from .common import check_out, device_record, emit, synchronize, time_fn, write_out

__all__ = ["CONFIGS", "run"]

# (name, adjoint, bulk_increments)
CONFIGS = (
    ("full", "full", False),
    ("recursive", "recursive", False),
    ("reversible", "reversible", False),
    ("reversible-bulk", "reversible", True),
)
RTOL = 1e-3
T1 = 2.0


def run(*, device=None, max_steps: int = 512, n_paths: int = 32,
        dim: int = 16) -> dict:
    device = resolve_device(device)
    term = transient_term()
    y0 = torch.ones(dim, dtype=torch.float64, device=device)
    keys = path_keys(PRNGKey(0, device=device), n_paths)

    def make_grad(adjoint, bulk):
        def value_and_grad():
            args = transient_args(device, requires_grad=True)
            r = sdeint(term, "ees25:adaptive", 0.0, T1, max_steps, y0, None,
                       args=args, adjoint=adjoint, rtol=RTOL, batch_keys=keys,
                       bulk_increments=bulk, device=device)
            loss = ((r.y_final - 0.2) ** 2).mean()
            loss.backward()
            return float(loss), {k: float(v.grad) for k, v in args.items()}

        return value_and_grad

    records, grads = [], {}
    for name, adjoint, bulk in CONFIGS:
        fn = make_grad(adjoint, bulk)
        peak = None
        if device.type == "cuda":
            synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        fn()  # also the warm call
        synchronize(device)
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device) - base
        outs = []
        us = time_fn(lambda: outs.append(fn()), device, warmup=0, iters=3)
        loss, grads[name] = outs[-1]
        records.append({"adjoint": name, "bulk_increments": bulk,
                        "peak_bytes": peak, "us_per_step": us, "loss": loss})
        emit(f"bench_reversible_adaptive/{name}", us,
             f"peak_bytes={peak},loss={loss:.6f}")
    for rec in records:
        rel = max(abs(grads[rec["adjoint"]][k] - grads["full"][k])
                  / (abs(grads["full"][k]) + 1e-30) for k in grads["full"])
        rec["grad_rel_err_vs_full"] = rel
        emit(f"bench_reversible_adaptive/graderr/{rec['adjoint']}", 0.0,
             f"rel={rel:.3e}")
    by = {r["adjoint"]: r for r in records}
    if by["full"]["peak_bytes"] and by["reversible"]["peak_bytes"]:
        emit("bench_reversible_adaptive/mem_ratio_full_over_reversible", 0.0,
             f"{by['full']['peak_bytes'] / by['reversible']['peak_bytes']:.1f}x")
    return {"device": device_record(device), "n_paths": n_paths, "dim": dim,
            "t1": T1, "rtol": RTOL, "max_steps": max_steps, "records": records,
            "grads": grads}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="write the JSON payload here")
    ap.add_argument("--max-steps", type=int, default=512)
    ap.add_argument("--paths", type=int, default=32)
    ap.add_argument("--dim", type=int, default=16)
    a = ap.parse_args(argv)
    check_out(a.out)
    write_out(a.out, run(device=a.device, max_steps=a.max_steps,
                         n_paths=a.paths, dim=a.dim))


if __name__ == "__main__":
    main()
