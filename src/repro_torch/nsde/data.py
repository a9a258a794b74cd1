"""Synthetic ground-truth dynamics (port of ``repro.nsde.data``): the OU
paths of Table 1, the stiff GBM of Table 7 (Appendix H.1), the
second-order stochastic Kuramoto model of Table 3 (Section 4, eq. (5))
and the rough volatility paths of Table 2 (Appendix H.2).

Numpy copies of the reference's generators with the same ``rng`` call
order, so the same seed gives the same arrays in both packages.
"""
from __future__ import annotations

import numpy as np

from .fbm import fbm_increments

__all__ = ["ou_paths", "stiff_gbm_matrix", "gbm_paths", "kuramoto_paths",
           "rough_vol_paths"]


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


def stiff_gbm_matrix(rng, d: int = 25) -> np.ndarray:
    """``A = Q diag(-20 (1 + i/d)) Q^T`` with ``Q`` from the QR of a Gaussian
    matrix: eigenvalues from -20 to -40."""
    lam = -20.0 * (1.0 + np.arange(d) / d)
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return (Q * lam) @ Q.T


def gbm_paths(rng, A: np.ndarray, batch: int, n_steps: int, T: float = 1.0,
              sigma: float = 0.1):
    """dy = A y dt + sigma y dW (Stratonovich ~ Ito for this test scale),
    simulated with a fine-grid exponential-Euler reference:
    ``(batch, n+1, d)`` from ``y0 = 1``."""
    d = A.shape[0]
    h = T / n_steps
    y = np.ones((batch, n_steps + 1, d))
    eAh = _expm(A * h)
    for n in range(n_steps):
        dW = rng.standard_normal((batch, 1)) * np.sqrt(h)
        y[:, n + 1] = (y[:, n] @ eAh.T) * np.exp(sigma * dW - 0.5 * sigma**2 * h)
    return y


def _expm(M):
    """``exp(M)`` by eigendecomposition (M diagonalizable)."""
    vals, vecs = np.linalg.eig(M)
    return (vecs @ np.diag(np.exp(vals)) @ np.linalg.inv(vecs)).real


def kuramoto_paths(rng, N: int, batch: int, n_steps: int, T: float = 5.0,
                   m: float = 1.0, K: float = 2.0, P: float = 0.5, D: float = 0.05,
                   subsample: int = 1):
    """Second-order stochastic Kuramoto (eq. (5)); returns (theta, omega)
    with shapes (batch, n//sub + 1, N).  Heun integration on a fine grid."""
    h = T / n_steps
    omega_nat = np.where(np.arange(N) % 2 == 0, P, -P)
    th = rng.uniform(-np.pi, np.pi, size=(batch, N))
    om = np.zeros((batch, N))
    ths = [th.copy()]
    oms = [om.copy()]

    def drift(th, om):
        sin_diff = np.sin(th[:, None, :] - th[:, :, None])
        coupling = K * sin_diff.mean(axis=2)
        return om, (-om + omega_nat + coupling) / m

    for n in range(n_steps):
        noise = np.sqrt(2 * D * h) * rng.standard_normal((batch, N)) / m
        d1_th, d1_om = drift(th, om)
        th_p = th + h * d1_th
        om_p = om + h * d1_om + noise
        d2_th, d2_om = drift(th_p, om_p)
        th = th + 0.5 * h * (d1_th + d2_th)
        om = om + 0.5 * h * (d1_om + d2_om) + noise
        th = np.mod(th + np.pi, 2 * np.pi) - np.pi
        if (n + 1) % subsample == 0:
            ths.append(th.copy())
            oms.append(om.copy())
    return np.stack(ths, axis=1), np.stack(oms, axis=1)


def rough_vol_paths(rng, batch: int, n_steps: int, T: float = 1.0,
                    H: float = 0.25, eta: float = 1.991, v0: float = 0.04,
                    s0: float = 1.0, rho: float = -0.848):
    """Rough-Bergomi-style price paths: v_t = v0 exp(eta W^H_t - eta^2 t^{2H}/2),
    dS/S = sqrt(v) dB with corr(B, driver of W^H) = rho.  Returns
    ``(S, v)``, each ``(batch, n+1)``."""
    h = T / n_steps
    t = np.arange(1, n_steps + 1) * h
    wh = np.cumsum(fbm_increments(rng, n_steps, H, T, batch), axis=1)
    v = v0 * np.exp(eta * wh - 0.5 * eta**2 * t ** (2 * H))
    z = rng.standard_normal((batch, n_steps))
    # cheap correlation proxy against the fGn increments
    g = np.diff(np.concatenate([np.zeros((batch, 1)), wh], axis=1), axis=1)
    g = g / (g.std() + 1e-12)
    dB = (rho * g + np.sqrt(1 - rho**2) * z) * np.sqrt(h)
    logS = np.cumsum(np.sqrt(v) * dB - 0.5 * v * h, axis=1)
    S = s0 * np.exp(np.concatenate([np.zeros((batch, 1)), logS], axis=1))
    return S, np.concatenate([np.full((batch, 1), v0), v], axis=1)
