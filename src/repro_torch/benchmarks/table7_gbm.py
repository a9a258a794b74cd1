"""Table 7 / Appendix H.1: stiff GBM — the stability separation.

Port of ``run()`` of ``benchmarks/table7_gbm.py``: integrate
``dy = A y dt + sigma y dW`` with a stiff ``A`` (eigenvalues from -20 to
-40, ``D = 10``, ``sigma = 0.1``, ``T = 1``, 64 paths from ``y0 = 1``) at a
fixed budget of 60 vector-field evaluations, with Reversible Heun, MCF-Euler,
MCF-Midpoint and EES(2,5) at their step counts for that budget.  Reported
per solver: ``terminal_max = max |y_T|``, ``stable`` (finite and below 10)
and the wall time.  Theorems 2.1/2.2: Reversible Heun's stability region is
the imaginary segment, so a real stiff mode diverges; EES(2,5) is stable for
``lambda*h`` in (-3.087, 0).  (The reference's docstring also describes a
training-stability part that its ``run()`` does not run; neither does this.)

``A`` comes from ``default_rng(1)`` and the noise from ``PRNGKey(0)`` with
``shape=(64, D)``, as in the reference, so a run sees the reference's
matrix and (to erfinv ulps) its increments.  Writes no file.  Run
``python -m repro_torch.benchmarks.table7_gbm`` (``--device cpu`` off the
GPU, ``--use-kernels`` for the CUDA kernels).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core import SDETerm, get_solver, prng, solve
from ..core.brownian import brownian_path
from ..device import resolve_device
from ..nsde import stiff_gbm_matrix

__all__ = ["solvers", "stiff_A", "gbm_term", "run_case", "run", "Row"]

D, SIGMA, T = 10, 0.1, 1.0
NFE = 60
N_PATHS = 64


def solvers(use_kernels: bool = False):
    """(label, registry spec, steps at the common NFE budget)."""
    tag = ":use_kernels=True" if use_kernels else ""
    return [
        ("RevHeun", "reversible_heun" + tag, NFE),
        ("MCF-Euler", "mcf-euler" + tag, NFE // 2),
        ("MCF-Midpoint", "mcf-midpoint" + tag, NFE // 4),
        ("EES(2,5)", "ees25" + tag, NFE // 3),
    ]


def stiff_A(rng) -> np.ndarray:
    """The reference's ``stiff_A``: :func:`~repro_torch.nsde.stiff_gbm_matrix`
    at ``d = D``."""
    return stiff_gbm_matrix(rng, D)


def gbm_term(A: torch.Tensor) -> SDETerm:
    return SDETerm(drift=lambda t, y, a: y @ A.T,
                   diffusion=lambda t, y, a: SIGMA * y, noise="diagonal")


class Row(NamedTuple):
    y_final: torch.Tensor   # (N_PATHS, D)
    terminal_max: float     # max |y_T| (nan if any entry is nan)
    stable: bool            # finite and below 10
    seconds: float          # wall time of the solve, device work included


def run_case(spec, n_steps, *, device=None) -> Row:
    """One solver's integration of the stiff GBM."""
    device = resolve_device(device)
    A = torch.as_tensor(stiff_A(np.random.default_rng(1)), dtype=torch.float32,
                        device=device)
    y0 = torch.ones((N_PATHS, D), dtype=torch.float32, device=device)
    bm = brownian_path(prng.PRNGKey(0, device=device), 0.0, T, n_steps,
                       shape=(N_PATHS, D), dtype=torch.float32)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    with torch.no_grad():
        y = solve(get_solver(spec), gbm_term(A), y0, bm, None).y_final
        norm = float(y.abs().max())
    seconds = time.perf_counter() - start
    return Row(y, norm, bool(np.isfinite(norm) and norm < 10.0), seconds)


def run(*, device=None, use_kernels: bool = False) -> Dict[str, Row]:
    """Every Table-7 solver; prints and returns one row per solver."""
    out = {}
    for name, spec, n_steps in solvers(use_kernels):
        r = run_case(spec, n_steps, device=device)
        out[name] = r
        print(f"table7_gbm/{name} ({spec}, {n_steps} steps): "
              f"terminal_max={r.terminal_max:.6e} stable={r.stable} "
              f"wall {r.seconds * 1e6:.1f} us", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--use-kernels", action="store_true",
                    help="route the solvers through the CUDA kernels")
    a = ap.parse_args(argv)
    run(device=a.device, use_kernels=a.use_kernels)


if __name__ == "__main__":
    main()
