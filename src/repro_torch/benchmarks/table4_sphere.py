"""Table 4 + Fig 6: latent SDE on the sphere S^{n-1}.

Port of ``benchmarks/table4_sphere.py`` at its sizes: the reference's
synthetic stand-in for UCI-HAR — a latent SDE on S^7 (n = 8, 28 noise
channels on the so(8) basis: general noise through ``noise_apply``) carries
a 4-class signal from class-dependent initial points to a linear head, 64
trajectories, T = 1, drift width 32.  Cases: geometric Euler-Maruyama with
the full adjoint (30 steps, the Zeng et al. baseline) and CF-EES(2,5) with
the reversible adjoint (10 steps, the same 30 evaluations), 25 AdamW epochs
at 5e-3 each; reported: the last epoch's cross-entropy, ms a step, and the
accuracy of the trained model on one more noise path.

The data reproduce the reference's draws, including its reuse of one key
for the class anchors and for the initial points' noise
(``benchmarks/table4_sphere.py:45-47``); labels come from
:func:`~repro_torch.core.prng.randint`, bit-exact to ``jax.random.randint``.

Fig 6: the peak memory of one value-and-grad at 32, 128 and 512 steps for
CF-EES(2,5) reversible and GeoEM full, with bulk and with per-step
increments (see :mod:`~repro_torch.benchmarks.table3_kuramoto`).

Run ``python -m repro_torch.benchmarks.table4_sphere`` (``--device cpu``
off the GPU, ``--epochs`` to shorten, ``--no-memory`` to skip Fig 6).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..core import get_solver, prng, solve
from ..core.brownian import brownian_path
from ..device import resolve_device
from ..nsde import SphereNSDE, init_sphere_nsde, sphere_nsde_term
from ..optim import adamw
from .common import emit, opt_step, peak_bytes, value_and_grad

__all__ = ["SphereClassifier", "init_params", "data", "cases", "make_loss",
           "accuracy", "train_case", "train", "memory_series", "run", "Run"]

N_SPHERE, BATCH, T, CLASSES = 8, 64, 1.0, 4
M_NOISE = N_SPHERE * (N_SPHERE - 1) // 2
NFE = 30
WIDTH = 32
EPOCHS = 25
LR = 5e-3
MEMORY_STEPS = (32, 128, 512)
MEMORY_CASES = (("reversible", "cfees25"), ("full", "geo-em"))


class SphereClassifier(nn.Module):
    """The reference's ``{"sde": ..., "head": ...}``: the sphere SDE and a
    ``(n, classes)`` linear head on the terminal point."""

    def __init__(self, sde: SphereNSDE, head: torch.Tensor):
        super().__init__()
        self.sde = sde
        self.head = nn.Parameter(head)


def init_params(key, *, dtype=torch.float32) -> SphereClassifier:
    """The reference's parameters: ``init_sphere_nsde(k1, 8, width=32)`` and
    ``head = 0.1 * normal(k1, (8, 4))`` with ``k1 = split(key)[0]``."""
    k1 = prng.split(key)[0]
    return SphereClassifier(
        init_sphere_nsde(k1, N_SPHERE, width=WIDTH, dtype=dtype, device=key.device),
        (0.1 * prng.normal(k1, (N_SPHERE, CLASSES))).to(dtype))


def data(key, dtype=torch.float32):
    """``(y0, labels)``: 64 points on S^7 near four random class anchors.
    The draws are float32 (the reference's, without x64), then cast."""
    k1, k2 = prng.split(key)
    labels = prng.randint(k1, (BATCH,), 0, CLASSES, dtype=torch.int32).to(torch.int64)
    anchors = prng.normal(k2, (CLASSES, N_SPHERE))
    anchors = anchors / torch.linalg.norm(anchors, dim=-1, keepdim=True)
    y0 = anchors[labels] + 0.1 * prng.normal(k2, (BATCH, N_SPHERE))
    y0 = y0 / torch.linalg.norm(y0, dim=-1, keepdim=True)
    return y0.to(dtype), labels


def cases(nfe: int = NFE):
    """(label, registry spec, adjoint, steps) at ``nfe`` evaluations."""
    return [
        ("GeoEM+Full", "geo-em", "full", nfe),
        ("CF-EES(2,5)+Reversible", "cfees25", "reversible", nfe // 3),
    ]


def make_loss(spec, adjoint, n_steps, **solve_kw):
    """``loss(params, key, y0, labels)``: the head's cross-entropy on the
    terminal points."""
    term = sphere_nsde_term(N_SPHERE)
    solver = get_solver(spec)

    def loss(p: SphereClassifier, k, y0, labels):
        bm = brownian_path(k, 0.0, T, n_steps, shape=(y0.shape[0], M_NOISE),
                           dtype=y0.dtype)
        r = solve(solver, term, y0, bm, p.sde, adjoint=adjoint, **solve_kw)
        logp = torch.log_softmax(r.y_final @ p.head, dim=-1)
        return -torch.take_along_dim(logp, labels[:, None], dim=1).mean()

    return loss


def accuracy(p: SphereClassifier, spec, n_steps, key, y0, labels) -> torch.Tensor:
    """Share of trajectories whose terminal point the head classifies right
    (a device scalar)."""
    bm = brownian_path(key, 0.0, T, n_steps, shape=(y0.shape[0], M_NOISE),
                       dtype=y0.dtype)
    with torch.no_grad():
        yf = solve(get_solver(spec), sphere_nsde_term(N_SPHERE), y0, bm, p.sde).y_final
        return ((yf @ p.head).argmax(-1) == labels).to(y0.dtype).mean()


class Run(NamedTuple):
    losses: List[float]      # the cross-entropy of each epoch (before its update)
    seconds: float           # wall time of the epochs, device work included
    accuracy: float
    params: SphereClassifier


def train_case(key, y0, labels, spec, adjoint, steps, *,
               epochs: Optional[int] = None) -> Run:
    """One case from ``key``: :func:`init_params` of it, ``epochs``
    (default :data:`EPOCHS`) AdamW steps, each on the second key of
    ``split(key)`` as the key moves on, and the accuracy on the key they
    leave."""
    epochs = EPOCHS if epochs is None else epochs
    params = init_params(key, dtype=y0.dtype)
    loss = make_loss(spec, adjoint, steps)
    opt = adamw(LR)
    state = opt.init(list(params.parameters()))
    losses = []
    if y0.device.type == "cuda":
        torch.cuda.synchronize(y0.device)
    start = time.perf_counter()
    for _ in range(epochs):
        key, sub = prng.split(key)
        val, state = opt_step(loss, params, opt, state, sub, y0, labels)
        losses.append(val)
    losses = [float(v) for v in losses]
    seconds = time.perf_counter() - start
    return Run(losses, seconds, float(accuracy(params, spec, steps, key, y0, labels)),
               params)


def train(key, y0, labels, *, epochs: Optional[int] = None) -> Dict[str, Run]:
    """Train both cases from the same initial parameters and keys, as the
    reference does."""
    return {name: train_case(key, y0, labels, spec, adjoint, steps, epochs=epochs)
            for name, spec, adjoint, steps in cases()}


def memory_series(params, key, y0, labels, *, steps: Optional[Sequence[int]] = None,
                  bulk_increments: bool = True) -> Dict[str, List[int]]:
    """Peak bytes of one value-and-grad at each step count (default
    :data:`MEMORY_STEPS`), per adjoint."""
    steps = MEMORY_STEPS if steps is None else steps
    return {adjoint: [peak_bytes(lambda: value_and_grad(
                make_loss(spec, adjoint, n, bulk_increments=bulk_increments),
                params, key, y0, labels), y0.device) for n in steps]
            for adjoint, spec in MEMORY_CASES}


def run(*, device=None, epochs: Optional[int] = None, memory: bool = True):
    """Table 4's cases, then Fig 6's series; prints CSV rows."""
    device = resolve_device(device)
    epochs = EPOCHS if epochs is None else epochs
    key = prng.PRNGKey(0, device=device)
    y0, labels = data(key)
    runs = train(key, y0, labels, epochs=epochs)
    for name, r in runs.items():
        emit(f"table4_sphere/{name}", r.seconds / epochs * 1e6,
             f"loss={r.losses[-1]:.6f};acc={r.accuracy:.4f}")
    if not memory:
        return runs, None
    params = init_params(key)
    series = {}
    for bulk in (False, True):
        tag = "bulk" if bulk else "per-step"
        series[tag] = memory_series(params, key, y0, labels, bulk_increments=bulk)
        for adjoint, s in series[tag].items():
            emit(f"fig6_memory/{adjoint}/{tag}", 0.0,
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
