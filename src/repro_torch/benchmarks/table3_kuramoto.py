"""Table 3 + Fig 5b: stochastic Kuramoto on T*T^N — CF-EES against CG2, and
the memory separation of the three adjoints.

Port of ``benchmarks/table3_kuramoto.py`` at its sizes: N = 16 oscillators,
32 trajectories, T = 2, 4 noise samples a trajectory, the Kuramoto NSDE at
width 64, AdamW 2e-3, 15 epochs; the target is the second-order Kuramoto
model's state at T (``kuramoto_paths(default_rng(3), 16, 32, 400, T=2)``).
Cases: CG2 with the full adjoint (30 steps), CG2 with the recursive adjoint
(30 steps) and CF-EES(2,5) with the reversible adjoint (20 steps, the same
60 vector-field evaluations).  Quality: the wrapped energy score of the last
epoch; speed: ms a training step.

The reference vmaps its solve over ``jax.random.split(key, 4)``; here those
four keys are one ``(4, 2)`` key batch of one Brownian path whose pytree
shape is ``((32, 16), (32, 16))``, so the draws are the reference's and the
state carries a leading sample axis.  Keys chain through the cases as the
reference's do (each case's parameters come from the key the previous case
left).

Fig 5b: the peak memory of one value-and-grad at 32, 128 and 512 steps per
adjoint (CF-EES(2,5) reversible, CG2 recursive and full).  The reference
reads XLA's ``temp_size_in_bytes``; the port reads the device's peak above
its inputs (``torch.cuda.max_memory_allocated``; ``LiveBytes`` on the CPU),
once with bulk increments and once with ``bulk_increments=False``: the bulk
draw's buffer grows with the step count under every adjoint, so only the
per-step series shows the reversible adjoint flat.

Run ``python -m repro_torch.benchmarks.table3_kuramoto`` (``--device cpu``
off the GPU, ``--epochs`` to shorten, ``--no-memory`` to skip Fig 5b).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import get_solver, prng, solve
from ..core.brownian import brownian_path
from ..device import resolve_device
from ..nsde import (KuramotoNSDE, init_kuramoto_nsde, kuramoto_nsde_term, kuramoto_paths,
                    wrapped_energy_score)
from ..optim import adamw
from .common import emit, opt_step, peak_bytes, value_and_grad

__all__ = ["data", "cases", "make_loss", "train_case", "train", "memory_series", "run",
           "Run"]

N, BATCH, T = 16, 32, 2.0
M_SAMPLES = 4
WIDTH = 64
EPOCHS = 15
LR = 2e-3
N_STEPS = 30
MEMORY_STEPS = (32, 128, 512)
MEMORY_CASES = (("reversible", "cfees25"), ("recursive", "cg2"), ("full", "cg2"))


def data(dtype=torch.float32, device=None):
    """``(th0, om0, target_th, target_om)``, each ``(32, 16)``: the
    Kuramoto model's state at 0 and at T (one subsampled step of 400)."""
    rng = np.random.default_rng(3)
    ths, oms = kuramoto_paths(rng, N, BATCH, 400, T=T, subsample=400)
    device = resolve_device(device)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (ths[:, 0], oms[:, 0], ths[:, -1], oms[:, -1]))


def cases(n_steps: int = N_STEPS):
    """(label, registry spec, adjoint, steps) at a budget of
    ``2 * n_steps`` vector-field evaluations."""
    return [
        ("CG2+Full", "cg2", "full", 2 * n_steps // 2),
        ("CG2+Recursive", "cg2", "recursive", 2 * n_steps // 2),
        ("CF-EES(2,5)+Reversible", "cfees25", "reversible", 2 * n_steps // 3),
    ]


def make_loss(spec, adjoint, n_steps, target_th, target_om, **solve_kw):
    """``loss(params, key, th0, om0)``: the wrapped energy score of the four
    samples at T against each target, averaged over the 32 targets."""
    term = kuramoto_nsde_term()
    solver = get_solver(spec)

    def loss(p: KuramotoNSDE, k, th0, om0):
        keys = prng.split(k, M_SAMPLES)
        bm = brownian_path(keys, 0.0, T, n_steps, shape=(tuple(th0.shape),) * 2,
                           dtype=th0.dtype)
        y0 = (th0.expand((M_SAMPLES,) + tuple(th0.shape)),
              om0.expand((M_SAMPLES,) + tuple(om0.shape)))
        r = solve(solver, term, y0, bm, p, adjoint=adjoint, batch_dims=1, **solve_kw)
        ths, oms = r.y_final  # (m, batch, N)
        return wrapped_energy_score(ths, oms, target_th, target_om).mean()

    return loss


class Run(NamedTuple):
    losses: List[float]     # the energy score of each epoch (before its update)
    seconds: float          # wall time of the epochs, device work included
    params: KuramotoNSDE    # the trained model
    start_key: torch.Tensor  # the key the case started from


def train_case(key, inputs, spec, adjoint, steps, *, epochs: Optional[int] = None):
    """One case from ``key``: parameters ``init_kuramoto_nsde(key)``, then
    ``epochs`` (default :data:`EPOCHS`) AdamW steps, each on the second key
    of ``split(key)`` as the key moves on.  ``inputs`` is :func:`data`'s
    tuple (its dtype and device are the run's).  Returns ``(Run, key)``."""
    th0, om0, tgt_th, tgt_om = inputs
    epochs = EPOCHS if epochs is None else epochs
    start_key = key
    params = init_kuramoto_nsde(key, N, width=WIDTH, dtype=th0.dtype, device=th0.device)
    loss = make_loss(spec, adjoint, steps, tgt_th, tgt_om)
    opt = adamw(LR)
    state = opt.init(list(params.parameters()))
    losses = []
    if th0.device.type == "cuda":
        torch.cuda.synchronize(th0.device)
    start = time.perf_counter()
    for _ in range(epochs):
        key, sub = prng.split(key)
        val, state = opt_step(loss, params, opt, state, sub, th0, om0)
        losses.append(val)
    losses = [float(v) for v in losses]  # one read-back a case
    return Run(losses, time.perf_counter() - start, params, start_key), key


def train(key, inputs, *, epochs: Optional[int] = None):
    """Train the three cases in order, the key chained through them as in
    the reference.  Returns ``({label: Run}, key)``."""
    out: Dict[str, Run] = {}
    for name, spec, adjoint, steps in cases():
        out[name], key = train_case(key, inputs, spec, adjoint, steps, epochs=epochs)
    return out, key


def memory_series(params, key, inputs, *, steps: Optional[Sequence[int]] = None,
                  bulk_increments: bool = True) -> Dict[str, List[int]]:
    """Peak bytes of one value-and-grad at each step count (default
    :data:`MEMORY_STEPS`), per adjoint."""
    th0, om0, tgt_th, tgt_om = inputs
    steps = MEMORY_STEPS if steps is None else steps
    out = {}
    for adjoint, spec in MEMORY_CASES:
        out[adjoint] = [
            peak_bytes(lambda: value_and_grad(
                make_loss(spec, adjoint, n, tgt_th, tgt_om,
                          bulk_increments=bulk_increments),
                params, key, th0, om0), th0.device)
            for n in steps]
    return out


def run(*, device=None, epochs: Optional[int] = None, memory: bool = True):
    """Table 3's cases, then Fig 5b's series; prints CSV rows."""
    device = resolve_device(device)
    epochs = EPOCHS if epochs is None else epochs
    inputs = data(device=device)
    runs, key = train(prng.PRNGKey(0, device=device), inputs, epochs=epochs)
    for name, r in runs.items():
        emit(f"table3_kuramoto/{name}", r.seconds / epochs * 1e6,
             f"energy_score={r.losses[-1]:.6f}")
    if not memory:
        return runs, None
    params = init_kuramoto_nsde(key, N, width=WIDTH, device=device)
    series = {}
    for bulk in (False, True):
        tag = "bulk" if bulk else "per-step"
        series[tag] = memory_series(params, key, inputs, bulk_increments=bulk)
        for adjoint, s in series[tag].items():
            emit(f"fig5b_memory/{adjoint}/{tag}", 0.0,
                 f"peak_bytes_32_128_512={s};growth16x={s[-1] / max(s[0], 1):.2f}")
    return runs, series


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--no-memory", action="store_true")
    a = ap.parse_args(argv)
    run(device=a.device, epochs=a.epochs, memory=not a.no_memory)


if __name__ == "__main__":
    main()
