"""Distribution-matching losses for NSDE training (port of
``repro.nsde.losses``, the marginal moment MSE)."""
from __future__ import annotations

__all__ = ["moment_mse"]


def moment_mse(gen, target):
    """gen, target: (batch, time[, dim]) — match mean and std trajectories.

    ``jnp.std`` is the population standard deviation, hence
    ``correction=0``."""
    gm, gs = gen.mean(dim=0), gen.std(dim=0, correction=0)
    tm, ts = target.mean(dim=0), target.std(dim=0, correction=0)
    return ((gm - tm) ** 2).mean() + ((gs - ts) ** 2).mean()
