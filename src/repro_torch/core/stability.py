"""Linear and mean-square stability analysis of explicit RK schemes
(port of ``repro.core.stability``, numpy only).

For the linear test equation ``dy = lambda y dt`` the update factor is the
stability polynomial ``R(rho)``, ``rho = lambda h``.  For the stochastic test
equation ``dy = lambda y dt + mu y dW`` the scheme applied to the (h, dW)
driver multiplies the state by ``R(rho)`` with the *random* argument
``rho = lambda h + mu dW ~ N(lambda h, mu^2 h)``, and mean-square stability is
``E|R(rho)|^2 < 1`` (Section 3).  We evaluate that expectation by
Gauss-Hermite quadrature — exact here, because |R|^2 is a polynomial in the
Gaussian variable.
"""
from __future__ import annotations

import numpy as np

from .tableaux import Tableau, stability_poly

__all__ = [
    "stability_function",
    "is_linearly_stable",
    "mean_square_factor",
    "is_mean_square_stable",
    "ms_stability_region",
]


def stability_function(tab: Tableau):
    coeffs = stability_poly(tab)

    def R(rho):
        rho = np.asarray(rho, dtype=complex)
        out = np.zeros_like(rho)
        for k in range(len(coeffs) - 1, -1, -1):
            out = out * rho + coeffs[k]
        return out

    return R


def is_linearly_stable(tab: Tableau, rho) -> np.ndarray:
    return np.abs(stability_function(tab)(rho)) < 1.0


def mean_square_factor(tab: Tableau, lam, mu, h, n_quad: int = 64):
    """E|R(lam*h + mu*dW)|^2 with dW ~ N(0, h), via Gauss-Hermite quadrature."""
    R = stability_function(tab)
    nodes, weights = np.polynomial.hermite_e.hermegauss(n_quad)  # weight e^{-x^2/2}
    lam = complex(lam)
    mu = complex(mu)
    rho = lam * h + mu * np.sqrt(h) * nodes
    vals = np.abs(R(rho)) ** 2
    return float((weights * vals).sum() / np.sqrt(2.0 * np.pi))


def is_mean_square_stable(tab: Tableau, lam, mu, h) -> bool:
    return mean_square_factor(tab, lam, mu, h) < 1.0


def ms_stability_region(tab: Tableau, lam_h_grid, mu2_h_grid):
    """Boolean grid of mean-square stability over (lambda h, mu^2 h) cross-sections
    (as in Figure 3; real lambda, real mu)."""
    out = np.zeros((len(lam_h_grid), len(mu2_h_grid)), dtype=bool)
    for i, lh in enumerate(lam_h_grid):
        for j, m2h in enumerate(mu2_h_grid):
            # parameterise with h = 1: lam = lh, mu = sqrt(m2h)
            out[i, j] = is_mean_square_stable(tab, lh, np.sqrt(max(m2h, 0.0)), 1.0)
    return out
