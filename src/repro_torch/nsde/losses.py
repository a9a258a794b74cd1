"""Distribution-matching losses for NSDE training (port of
``repro.nsde.losses``): the marginal moment MSE (the OU and GBM
experiments), the wrapped energy score (the Kuramoto experiment) and the
truncated signature MMD (the stochastic-volatility experiment)."""
from __future__ import annotations

import math

import torch

__all__ = ["moment_mse", "wrapped_energy_score", "signature_mmd"]


def moment_mse(gen, target):
    """gen, target: (batch, time[, dim]) — match mean and std trajectories.

    ``jnp.std`` is the population standard deviation, hence
    ``correction=0``."""
    gm, gs = gen.mean(dim=0), gen.std(dim=0, correction=0)
    tm, ts = target.mean(dim=0), target.std(dim=0, correction=0)
    return ((gm - tm) ** 2).mean() + ((gs - ts) ** 2).mean()


def _wrap(x):
    return x - 2 * math.pi * torch.round(x / (2 * math.pi))


def wrapped_energy_score(samples_th, samples_om, target_th, target_om):
    """Energy score ES = E d(X, y) - 1/2 E d(X, X') with the wrapped-on-theta
    distance d = sum|wrap(dth)| + sum|dom|.

    samples: ``(m, *batch, N)``; target: ``(*batch, N)``; returns one score
    per target, ``batch``-shaped (a scalar for the reference's ``(m, N)``
    and ``(N,)``: the reference maps targets with ``vmap``)."""

    def dist(th_a, om_a, th_b, om_b):
        return (torch.abs(_wrap(th_a - th_b)).sum(-1)
                + torch.abs(om_a - om_b).sum(-1))

    m = samples_th.shape[0]
    term1 = dist(samples_th, samples_om, target_th[None], target_om[None]).mean(0)
    d2 = dist(samples_th[:, None], samples_om[:, None], samples_th[None],
              samples_om[None])
    term2 = d2.sum(dim=(0, 1)) / (2 * m * (m - 1) + 1e-9)
    return term1 - term2


def _signature_l3(path):
    """Truncated signature (levels 1..3) of piecewise-linear paths
    ``(..., T, d)``: ``(..., d + d^2 + d^3)``.

    Level-k terms are iterated integrals; for a piecewise-linear path they
    reduce to iterated sums with the in-segment Chen corrections (1/2 at
    level 2; 1/2, 1/2, 1/6 at level 3).  The reference maps one path with
    ``vmap``; here the leading axes carry the batch.
    """
    dx = torch.diff(path, dim=-2)  # (..., T-1, d)
    s1 = dx.sum(dim=-2)
    pre = torch.cumsum(dx, dim=-2) - dx  # increment strictly before each segment
    seg2 = (torch.einsum("...ti,...tj->...tij", pre, dx)
            + 0.5 * torch.einsum("...ti,...tj->...tij", dx, dx))
    s2 = seg2.sum(dim=-3)
    pre2 = torch.cumsum(seg2, dim=-3) - seg2  # level-2 signature before segment
    s3 = (torch.einsum("...tij,...tk->...ijk", pre2, dx)
          + 0.5 * torch.einsum("...ti,...tj,...tk->...ijk", pre, dx, dx)
          + (1.0 / 6.0) * torch.einsum("...ti,...tj,...tk->...ijk", dx, dx, dx))
    lead = path.shape[:-2]
    return torch.cat([s1.reshape(*lead, -1), s2.reshape(*lead, -1),
                      s3.reshape(*lead, -1)], dim=-1)


def signature_mmd(gen_paths, target_paths, times=None):
    """|| E sig(gen) - E sig(target) ||^2 over time-augmented paths.

    gen/target: (batch, T) or (batch, T, d) tensors (``target`` may be a
    numpy array; it is moved to ``gen``'s dtype and device).  ``times``
    (default ``linspace(0, 1, T)``) is the augmenting time channel.
    """
    target_paths = torch.as_tensor(target_paths, dtype=gen_paths.dtype,
                                   device=gen_paths.device)
    if gen_paths.dim() == 2:
        gen_paths = gen_paths[..., None]
        target_paths = target_paths[..., None]
    T = gen_paths.shape[1]
    if times is None:
        times = torch.linspace(0.0, 1.0, T, dtype=gen_paths.dtype,
                               device=gen_paths.device)
    times = torch.as_tensor(times, dtype=gen_paths.dtype, device=gen_paths.device)

    def sig(p):
        t = times[:, None].expand(p.shape[0], T, 1)
        return _signature_l3(torch.cat([t, p], dim=-1))

    return ((sig(gen_paths).mean(dim=0) - sig(target_paths).mean(dim=0)) ** 2).sum()
