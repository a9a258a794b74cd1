"""Fractional Brownian motion generation (port of ``repro.nsde.fbm``, for the
rough-driver experiments).

A numpy copy of the reference's generator with the same ``rng`` call order,
so the same seed gives the same arrays in both packages.  Davies-Harte
circulant embedding gives exact fBm increments in O(n log n); it falls back
to Cholesky if the circulant eigenvalues go negative (only for pathological
``(H, n)`` combinations), and ``H = 1/2`` is plain Brownian motion.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fbm_increments", "fbm_paths"]


def _autocov(k: np.ndarray, H: float) -> np.ndarray:
    """Autocovariance of unit-variance fGn: gamma(k)."""
    return 0.5 * (
        np.abs(k - 1) ** (2 * H) - 2 * np.abs(k) ** (2 * H) + np.abs(k + 1) ** (2 * H)
    )


def fbm_increments(rng: np.random.Generator, n: int, H: float, T: float = 1.0,
                   batch: int = 1) -> np.ndarray:
    """(batch, n) increments of fBm with Hurst H over [0, T] (exact in law)."""
    if abs(H - 0.5) < 1e-12:
        return rng.standard_normal((batch, n)) * (T / n) ** 0.5
    gamma = _autocov(np.arange(n, dtype=np.float64), H)
    row = np.concatenate([gamma, [0.0], gamma[-1:0:-1]])  # circulant first row, 2n
    eig = np.fft.fft(row).real
    if np.min(eig) < -1e-8:
        # Cholesky fallback (O(n^2) memory and time)
        cov = _autocov(np.subtract.outer(np.arange(n), np.arange(n)), H)
        L = np.linalg.cholesky(cov + 1e-12 * np.eye(n))
        z = rng.standard_normal((batch, n))
        out = z @ L.T
    else:
        eig = np.maximum(eig, 0.0)
        m = 2 * n
        z = rng.standard_normal((batch, m)) + 1j * rng.standard_normal((batch, m))
        w = np.fft.fft(z * np.sqrt(eig / (2 * m)), axis=1)
        out = w[:, :n].real * np.sqrt(2.0)
    return out * (T / n) ** H


def fbm_paths(rng, n: int, H: float, T: float = 1.0, batch: int = 1,
              dim: int = 1) -> np.ndarray:
    """(batch, n+1, dim) sample paths, starting at 0."""
    incs = np.stack(
        [fbm_increments(rng, n, H, T, batch) for _ in range(dim)], axis=-1
    )
    return np.concatenate(
        [np.zeros((batch, 1, dim)), np.cumsum(incs, axis=1)], axis=1
    )
