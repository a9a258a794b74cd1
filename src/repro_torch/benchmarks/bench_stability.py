"""Large-step stability frontiers: EES vs Reversible Heun vs Milstein.

Port of ``benchmarks/bench_stability.py``: integrate the contractive linear
test SDE

    dy = -lam * y dt + mu * y dW          (diagonal multiplicative noise)

across a stiffness sweep ``lam`` x a dyadic evaluation-budget sweep, every
solver spending the same number of vector-field evaluations per unit time
(``n_steps = round(budget / evals_per_step)``), 64 paths of dimension 4 from
``y0 = 1`` in float64, keys ``split(PRNGKey(0), 64)``.  The true solution is
mean-square contractive, so a run is **stable** iff its Monte-Carlo mean
square ``E|y_T|^2`` is finite and at most ``E|y_0|^2 = 1``.  Per solver and
stiffness the **frontier** is the largest stable step size and the smallest
stable budget.  Theorem 2.1: Reversible Heun's stability region is the
imaginary segment, so its frontier is empty at every stiffness, while
EES(2,5)'s holds a real-axis interval; :func:`gate` is the reference's
check of that (``tools/check_bench.py::check_stability``).

By default it writes no file; ``--out PATH`` writes the JSON payload there
(never as ``BENCH_*.json``, the name the reference's bench gate owns).  Run
``python -m repro_torch.benchmarks.bench_stability`` (``--device cpu`` off
the GPU).
"""
from __future__ import annotations

import argparse
import fnmatch
import json
import math
import os
from typing import Dict, List, Sequence

import torch

from ..core import SDETerm, get_solver, prng, sdeint
from ..device import resolve_device

__all__ = ["SOLVERS", "STIFFNESS", "BUDGETS", "linear_term", "evals_per_step",
           "mean_square_final", "run", "gate"]

SOLVERS = ("ees25", "ees27", "reversible-heun", "milstein")
STIFFNESS = (2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
BUDGETS = (32, 64, 128, 256, 512, 1024, 2048)  # evals over [0, T1] per path
N_PATHS = 64
DIM = 4
T1 = 1.0
MU = 0.5            # multiplicative noise level
MS_THRESHOLD = 1.0  # stable iff E[y_T^2] <= E[y_0^2] (y0 = 1, contractive SDE)


def linear_term() -> SDETerm:
    return SDETerm(drift=lambda t, y, a: -a * y,
                   diffusion=lambda t, y, a: MU * y, noise="diagonal")


def evals_per_step(spec: str) -> int:
    return int(get_solver(spec).evals_per_step)


def mean_square_final(spec, term, lam, n_steps, keys, y0) -> float:
    """E[y_T^2] (the mean over paths and dimensions) on a fixed grid."""
    with torch.no_grad():
        lam_t = torch.tensor(lam, dtype=y0.dtype, device=y0.device)
        out = sdeint(term, spec, 0.0, T1, n_steps, y0, args=lam_t,
                     batch_keys=keys, device=y0.device).y_final
        return float((out ** 2).mean())


def run(*, device=None, solvers: Sequence[str] = SOLVERS,
        stiffness: Sequence[float] = STIFFNESS,
        budgets: Sequence[int] = BUDGETS, verbose: bool = True) -> dict:
    """The sweep: the reference's payload (records and frontiers)."""
    device = resolve_device(device)
    term = linear_term()
    y0 = torch.ones(DIM, dtype=torch.float64, device=device)
    keys = prng.split(prng.PRNGKey(0, device=device), N_PATHS)
    records: List[dict] = []
    frontiers: Dict[str, dict] = {}
    for spec in solvers:
        eps = evals_per_step(spec)
        frontiers[spec] = {}
        for lam in stiffness:
            max_stable_h, min_stable_budget = 0.0, None
            for budget in budgets:
                n_steps = max(1, round(budget / eps))
                h = T1 / n_steps
                ms = mean_square_final(spec, term, lam, n_steps, keys, y0)
                stable = math.isfinite(ms) and ms <= MS_THRESHOLD
                records.append({"solver": spec, "stiffness": lam,
                                "budget": budget, "n_steps": n_steps, "h": h,
                                "ms_final": ms if math.isfinite(ms) else None,
                                "stable": stable})
                if stable:
                    max_stable_h = max(max_stable_h, h)
                    if min_stable_budget is None or budget < min_stable_budget:
                        min_stable_budget = budget
            frontiers[spec][f"{lam:g}"] = {"max_stable_h": max_stable_h,
                                           "min_stable_budget": min_stable_budget}
            if verbose:
                print(f"bench_stability/{spec}/lam{lam:g}: max_stable_h="
                      f"{max_stable_h:.4g} min_budget={min_stable_budget}",
                      flush=True)
    return {"device": device.type, "n_paths": N_PATHS, "dim": DIM, "t1": T1,
            "mu": MU, "ms_threshold": MS_THRESHOLD,
            "stiffness": list(stiffness), "budgets": list(budgets),
            "solvers": list(solvers), "records": records,
            "frontiers": frontiers}


def gate(payload: dict) -> List[str]:
    """The reference's bench gate on a payload: at every stiffness EES(2,5)'s
    frontier is finite and positive and at least Reversible Heun's.
    Returns the failures (empty when it passes)."""
    fr, bad = payload["frontiers"], []
    for lam in (f"{s:g}" for s in payload["stiffness"]):
        e = fr["ees25"][lam]["max_stable_h"]
        r = fr["reversible-heun"][lam]["max_stable_h"]
        if not (math.isfinite(e) and e > 0 and e >= r):
            bad.append(f"lam {lam}: ees25 {e} against reversible-heun {r}")
    return bad


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None,
                    help="write the JSON payload to this path")
    a = ap.parse_args(argv)
    if a.out is not None and fnmatch.fnmatch(os.path.basename(a.out), "BENCH_*.json"):
        raise SystemExit("--out must not be named BENCH_*.json: the reference's "
                         "bench gate owns that name")
    payload = run(device=a.device)
    bad = gate(payload)
    print(f"gate (EES(2,5) frontier finite, positive, >= Reversible Heun's): "
          f"{'pass' if not bad else bad}", flush=True)
    if a.out is not None:
        with open(a.out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"# wrote {a.out}", flush=True)


if __name__ == "__main__":
    main()
