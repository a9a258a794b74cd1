"""Synthetic ground-truth dynamics (port of ``repro.nsde.data``, the OU
paths of Table 1).

A numpy copy of the reference's generator with the same ``rng`` call order,
so the same seed gives the same target array in both packages.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ou_paths"]


def ou_paths(rng, batch: int, n_steps: int, T: float = 10.0,
             nu: float = 0.2, mu: float = 0.1, sigma: float = 2.0):
    """(batch, n+1) exact OU sample paths (exact transition sampling)."""
    h = T / n_steps
    x = np.zeros((batch, n_steps + 1))
    x[:, 0] = rng.standard_normal(batch) * 0.1
    a = np.exp(-nu * h)
    sd = sigma * np.sqrt((1 - a * a) / (2 * nu))
    for n in range(n_steps):
        x[:, n + 1] = mu + (x[:, n] - mu) * a + sd * rng.standard_normal(batch)
    return x
