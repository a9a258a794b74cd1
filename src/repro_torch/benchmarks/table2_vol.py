"""Table 2 / H.2: stochastic volatility — runtime at a fixed evaluation budget.

Port of ``benchmarks/table2_vol.py``: an untrained neural Langevin SDE
(``d_obs = 1``, ``d_z = 8``, width 16; runtime does not depend on the
weights) over ``[0, 1]`` at a budget of 504 vector-field evaluations, 256
paths, with Reversible Heun, MCF-Euler, MCF-Midpoint and EES(2,5) at their
step counts for that budget.  The loss is the signature MMD of
``1 + 0.1 * readout`` at 6 save points against rough-volatility target
paths (``rough_vol_paths(default_rng(2), 256, 60, H=0.25)``, every 10th
point after the first); reported per solver: the milliseconds of one
forward + backward (value and gradient) and the loss.

The paper's claim: at matched NFE all reversible solvers reach the same
terminal error, so runtime decides, and the 2N recurrence of EES(2,5) wins.

Weights are ``init_lsde(PRNGKey(0))`` and the noise one ``PRNGKey(0)`` path
of shape ``(256, 8)``, as in the reference.  ``--adjoint`` picks the
gradient: ``reversible`` (default, as the reference), ``full`` or
``recursive``.  Writes no file.  Run ``python -m
repro_torch.benchmarks.table2_vol`` (``--device cpu`` off the GPU,
``--use-kernels`` for the CUDA kernels).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core import get_solver, prng, solve
from ..core.brownian import brownian_path
from ..device import resolve_device
from .common import value_and_grad
from ..nsde import LSDE, init_lsde, lsde_readout, lsde_term, rough_vol_paths, signature_mmd

__all__ = ["solvers", "target_paths", "make_loss", "value_and_grad", "run", "Row"]

NFE = 504
BATCH, D_Z, WIDTH = 256, 8, 16
T = 1.0
N_OBS = 6
ITERS = 3  # timed calls after a warm one, the median kept (the reference's time_fn)


def solvers(use_kernels: bool = False, nfe: int = NFE):
    """(label, registry spec, steps at the common NFE budget)."""
    tag = ":use_kernels=True" if use_kernels else ""
    return [
        ("RevHeun", "reversible_heun" + tag, nfe),
        ("MCF-Euler", "mcf-euler" + tag, nfe // 2),
        ("MCF-Midpoint", "mcf-midpoint" + tag, nfe // 4),
        ("EES(2,5)", "ees25" + tag, nfe // 3),
    ]


def target_paths(batch: int = BATCH) -> np.ndarray:
    """The reference's target: rough-vol prices at 6 observation times,
    ``(batch, 6)`` float64."""
    S, _ = rough_vol_paths(np.random.default_rng(2), batch, 60, T=T, H=0.25)
    return S[:, ::10][:, 1:]


def make_loss(spec, n_steps, target, *, batch: int = BATCH,
              adjoint: str = "reversible", **solve_kw):
    """``loss(params, key)`` of the reference's Table 2: the signature MMD of
    the read-out saves against ``target`` (a tensor on the device)."""
    solver = get_solver(spec)
    term = lsde_term()
    save_every = n_steps // N_OBS

    def loss(p: LSDE, key):
        dtype = p.encoder.b.dtype
        bm = brownian_path(key, 0.0, T, n_steps, shape=(batch, p.encoder.b.shape[-1]),
                           dtype=dtype)
        z0 = torch.zeros((batch, p.encoder.b.shape[-1]), dtype=dtype,
                         device=key.device) + p.encoder.b
        r = solve(solver, term, z0, bm, p, adjoint=adjoint,
                  save_every=save_every, **solve_kw)
        ys = lsde_readout(p, r.ys)[..., 0].T  # (batch, 6)
        return signature_mmd(1.0 + 0.1 * ys, target)

    return loss


class Row(NamedTuple):
    loss: float        # sig_mmd
    ms: float          # one forward + backward, host wall, device work included


def run(*, device=None, use_kernels: bool = False,
        adjoint: str = "reversible") -> Dict[str, Row]:
    """Every Table-2 solver: one warm call, then the median of ``ITERS``
    timed calls; prints and returns one row per solver."""
    device = resolve_device(device)
    target = torch.as_tensor(target_paths(), dtype=torch.float32, device=device)
    key = prng.PRNGKey(0, device=device)
    params = init_lsde(key, 1, D_Z, width=WIDTH, device=device)
    out = {}
    for name, spec, n_steps in solvers(use_kernels):
        loss = make_loss(spec, n_steps, target, adjoint=adjoint)
        value_and_grad(loss, params, key)  # warm
        times = []
        for _ in range(ITERS):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            start = time.perf_counter()
            val, _ = value_and_grad(loss, params, key)
            float(val)
            times.append(time.perf_counter() - start)
        ms = sorted(times)[len(times) // 2] * 1e3
        out[name] = Row(float(val), ms)
        print(f"table2_vol/{name} ({spec}, {n_steps} steps, adjoint={adjoint}): "
              f"{ms:.3f} ms per forward + backward, sig_mmd={float(val):.6f}, "
              f"nfe={NFE}", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--use-kernels", action="store_true",
                    help="route the solvers through the CUDA kernels")
    ap.add_argument("--adjoint", default="reversible",
                    choices=("full", "recursive", "reversible"))
    a = ap.parse_args(argv)
    run(device=a.device, use_kernels=a.use_kernels, adjoint=a.adjoint)


if __name__ == "__main__":
    main()
