"""Figs 7/8 + Appendix G: strong convergence and backward-recovery rates.

Port of ``benchmarks/fig_convergence.py``, in float64: Euclidean EES(2,5)
and EES(2,7) on the 2-driver RDE ``dy = cos(y) dX1 + sin(y) dX2`` driven by
fBm (H = 0.5 and 0.6), and CF-EES(2,5) on the SO(3) RDE of Appendix G.
Measured: the global strong error against a fine reference (slope expected
near ``min(2H - 1/2 - eps, (p + 1) alpha - 1)`` forward) and the
backward-recovery error after integrating back (slope near ``6H - 1`` for
EES(2,5): the effective-symmetry order).  The fBm increments come from the
same numpy generator as the reference's
(:func:`~repro_torch.nsde.fbm.fbm_increments`), so the errors are the
reference's to rounding.

Run ``python -m repro_torch.benchmarks.fig_convergence`` (``--device cpu``
off the GPU).
"""
from __future__ import annotations

import argparse
from typing import List, NamedTuple

import numpy as np
import torch

from ..core import ManifoldSDETerm, SDETerm, SO3, cfees25_solver, ees25_solver, ees27_solver
from ..device import resolve_device
from ..nsde.fbm import fbm_increments
from .common import emit

__all__ = ["euclidean_rates", "so3_rates", "Rates", "run"]

F64 = torch.float64


class Rates(NamedTuple):
    fwd: float            # fitted forward strong-error slope
    bwd: float            # fitted backward-recovery slope
    errs: List[float]     # forward error per level (the mean over samples)
    rerrs: List[float]    # backward-recovery error per level
    y_ref: torch.Tensor   # the last fine-grid reference solution


def _drive(solver, term, y0, incs, reverse=False):
    """Integrate with explicit per-step 2-channel increments (h folded in)."""
    y = y0
    for i in range(incs.shape[0]):
        y = solver.step(term, y, 0.0, 0.0, incs[i], None)
    if not reverse:
        return y
    for i in range(incs.shape[0] - 1, -1, -1):
        y = solver.reverse(term, y, 0.0, 0.0, incs[i], None)
    return y


def _fit(errs, ns) -> float:
    return float(np.polyfit(np.log([1.0 / n for n in ns]), np.log(errs), 1)[0])


def euclidean_rates(H: float, solver, name: str, *, device=None) -> Rates:
    """Three fBm samples (``default_rng(5)``) on a 1024-step fine grid,
    levels 32..256; the errors are each level's mean over the samples."""
    device = resolve_device(device)
    term = SDETerm(
        drift=lambda t, y, a: torch.zeros_like(y),
        diffusion=lambda t, y, a: torch.stack([torch.cos(y), torch.sin(y)], -1),
        noise="general",
    )
    rng = np.random.default_rng(5)
    n_ref, ns = 1024, [32, 64, 128, 256]
    errs = {n: [] for n in ns}
    rerrs = {n: [] for n in ns}
    y0 = torch.tensor([1.0], dtype=F64, device=device)
    ref = None
    for _ in range(3):
        fine = np.stack([fbm_increments(rng, n_ref, H, 1.0)[0] for _ in range(2)], -1)
        ref = _drive(solver, term, y0, torch.as_tensor(fine, device=device))
        for n in ns:
            inc = torch.as_tensor(fine.reshape(n, n_ref // n, 2).sum(1), device=device)
            errs[n].append((_drive(solver, term, y0, inc) - ref).abs()[0])
            rerrs[n].append((_drive(solver, term, y0, inc, reverse=True) - y0).abs()[0])
    e = [float(torch.stack(errs[n]).mean()) for n in ns]
    r = [float(torch.stack(rerrs[n]).mean()) for n in ns]
    out = Rates(_fit([x + 1e-16 for x in e], ns), _fit([x + 1e-16 for x in r], ns),
                e, r, ref)
    emit(f"fig7_convergence/{name}/H={H}", 0.0,
         f"fwd_rate={out.fwd:.2f};bwd_recovery_rate={out.bwd:.2f}")
    return out


def so3_term() -> ManifoldSDETerm:
    """Appendix G's SO(3) RDE: two state-dependent so(3) generators, no
    drift."""
    def xi(t, y, a):
        g1 = torch.stack([0.1 + 0.3 * y[..., 2, 0], -(0.25 + 0.2 * y[..., 1, 2]),
                          0.9 + 0.2 * y[..., 0, 0]], -1)
        g2 = torch.stack([0.8 + 0.15 * y[..., 2, 2], 0.15 + 0.25 * y[..., 0, 1],
                          0.35 - 0.2 * y[..., 1, 1]], -1)
        return torch.stack([g1, g2], -1)  # (..., 3, 2)

    return ManifoldSDETerm(
        group=SO3(),
        drift=lambda t, y, a: torch.zeros(3, dtype=y.dtype, device=y.device),
        diffusion=xi,
        noise="general",
        noise_apply=lambda g, dw: torch.einsum("...ij,...j->...i", g, dw),
    )


def so3_rates(H: float, *, device=None) -> Rates:
    """One fBm sample (``default_rng(7)``) on a 512-step fine grid, levels
    32..128, errors the max-norm of the matrix difference."""
    device = resolve_device(device)
    term = so3_term()
    solver = cfees25_solver()
    rng = np.random.default_rng(7)
    n_ref, ns = 512, [32, 64, 128]
    fine = np.stack([fbm_increments(rng, n_ref, H, 1.0)[0] for _ in range(2)], -1)
    y0 = torch.eye(3, dtype=F64, device=device)
    ref = _drive(solver, term, y0, torch.as_tensor(fine, device=device))
    errs, rerrs = [], []
    for n in ns:
        inc = torch.as_tensor(fine.reshape(n, n_ref // n, 2).sum(1), device=device)
        errs.append((_drive(solver, term, y0, inc) - ref).abs().max())
        rerrs.append((_drive(solver, term, y0, inc, reverse=True) - y0).abs().max())
    e, r = [float(x) for x in errs], [float(x) for x in rerrs]
    out = Rates(_fit(np.asarray(e) + 1e-16, ns), _fit(np.asarray(r) + 1e-16, ns),
                e, r, ref)
    emit(f"fig8_convergence/CF-EES25-SO3/H={H}", 0.0,
         f"fwd_rate={out.fwd:.2f};bwd_recovery_rate={out.bwd:.2f}")
    return out


def run(*, device=None):
    """The reference's four rate sweeps, in its order."""
    out = {}
    for H in (0.5, 0.6):
        out[f"EES25/H={H}"] = euclidean_rates(H, ees25_solver(), "EES25", device=device)
    out["EES27/H=0.5"] = euclidean_rates(0.5, ees27_solver(), "EES27", device=device)
    out["CF-EES25-SO3/H=0.5"] = so3_rates(0.5, device=device)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    run(device=a.device)


if __name__ == "__main__":
    main()
