"""Table 1: high-volatility OU — stability of reversible solvers in training.

Port of ``benchmarks/table1_ou.py``: the neural Langevin SDE
(``d_obs=1, d_z=16, width=32``) trained with AdamW against the moments of
exact OU(nu=0.2, mu=0.1, sigma=2) paths at a fixed budget of 24
vector-field evaluations per integration, through
:func:`~repro_torch.train.make_sde_train_step` with the O(1)-memory
reversible adjoint.  Reported per solver: the terminal moment-MSE and the
wall time per training step.  The paper's claim: EES(2,5) stays stable
where Reversible Heun and MCF degrade.

Keys come from ``prng.PRNGKey(seed)`` / ``prng.split`` as in the reference,
so a seed gives the reference's initial weights and noise.  Writes no file.
Run ``python -m repro_torch.benchmarks.table1_ou`` (``--device cpu`` off the
GPU, ``--epochs`` to shorten).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core import prng
from ..device import resolve_device
from ..nsde import LSDE, init_lsde, lsde_readout, lsde_term, moment_mse, ou_paths
from ..optim import adamw
from ..train import make_sde_train_step

__all__ = ["solvers", "target_paths", "train_one", "run", "TrainRun"]

T, NFE = 2.0, 24
D_OBS, D_Z, WIDTH = 1, 16, 32
EPOCHS, BATCH = 60, 256


def solvers():
    """(label, registry spec, steps at the common NFE budget); the specs take
    the CUDA kernels (``:use_kernels=True``)."""
    return [
        ("RevHeun", "reversible_heun:use_kernels=True", NFE),
        ("MCF-Euler", "mcf-euler:use_kernels=True", NFE // 2),
        ("MCF-Midpoint", "mcf-midpoint:use_kernels=True", NFE // 4),
        ("EES(2,5)", "ees25:use_kernels=True", NFE // 3),
    ]


def target_paths(seed: int = 0, n_saves: int = 2):
    """The reference's target: exact OU marginals at ``n_saves`` times after
    t=0, ``(4096, n_saves)`` float64."""
    return ou_paths(np.random.default_rng(seed), 4096, n_saves, T=T)[:, 1:]


class TrainRun(NamedTuple):
    loss: float            # terminal moment-MSE (the last epoch's loss)
    seconds: float         # wall time of the epochs (device work included)
    losses: List[float]    # per-epoch losses
    skipped: int           # updates the guard skipped (non-finite batches)
    params: LSDE           # the trained model


def train_one(solver_spec, n_steps, target, seed=0, *, device=None,
              epochs: Optional[int] = None,
              params: Optional[LSDE] = None) -> TrainRun:
    """Train one solver for ``epochs`` (default ``EPOCHS``) steps of
    ``BATCH`` paths, in float32.

    ``params`` (default: ``init_lsde`` from the seed's key, as the
    reference) gives other initial weights; they are trained in place."""
    epochs = EPOCHS if epochs is None else epochs
    device = resolve_device(device)
    key = prng.PRNGKey(seed, device=device)
    if params is None:
        params = init_lsde(key, D_OBS, D_Z, width=WIDTH, device=device)
    opt = adamw(1e-2)
    state = opt.init(list(params.parameters()))
    tgt = torch.as_tensor(target, dtype=torch.float32, device=device)
    n_saves = target.shape[1]

    def loss_of_result(p, r):
        ys = lsde_readout(p, r.ys)[..., 0]  # (n_paths, n_saves)
        return moment_mse(ys, tgt)

    step = make_sde_train_step(
        solver_spec, lsde_term(), opt,
        y0_fn=lambda p: torch.zeros(D_Z, device=device) + p.encoder.b,
        loss_fn_result=loss_of_result,
        t0=0.0, t1=T, n_steps=n_steps, n_paths=BATCH,
        adjoint="reversible", save_every=n_steps // n_saves, device=device,
    )
    losses, skipped = [], []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    for _ in range(epochs):
        key, sub = prng.split(key)
        params, state, m = step(params, state, sub)
        losses.append(m["loss"])
        skipped.append(m["skipped"])
    # One read-back for the whole run (it waits for the device).
    losses = torch.stack(losses).tolist()
    n_skipped = int(torch.stack(skipped).sum())
    seconds = time.perf_counter() - start
    return TrainRun(losses[-1], seconds, losses, n_skipped, params)


def run(*, device=None, epochs: Optional[int] = None) -> Dict[str, TrainRun]:
    """Train every Table-1 solver; prints and returns one row per solver."""
    epochs = EPOCHS if epochs is None else epochs
    target = target_paths()
    out = {}
    for name, spec, n_steps in solvers():
        r = train_one(spec, n_steps, target, device=device, epochs=epochs)
        out[name] = r
        tag = "nan" if not np.isfinite(r.loss) else f"{r.loss:.4f}"
        print(f"table1_ou/{name}: {r.seconds / epochs * 1e6:.1f} us/step "
              f"terminal_mse={tag} skipped={r.skipped}", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    a = ap.parse_args(argv)
    run(device=a.device, epochs=a.epochs)


if __name__ == "__main__":
    main()
