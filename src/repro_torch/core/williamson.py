"""Williamson 2N-storage realisations of explicit Runge-Kutta schemes.

Port of ``repro.core.williamson`` (numpy only, no jax): the same closed
forms, so every coefficient equals the reference's bit for bit.

A Williamson 2N scheme runs one RK step with two registers::

    delta_l = A_l delta_{l-1} + F(Y_{l-1})
    Y_l     = Y_{l-1} + B_l delta_l,            l = 1..s,  A_1 = 0,

(eq. (2) of the paper, with ``F`` the driver-weighted vector-field increment).
Bazavov's Theorem 3.1 characterises which tableaux admit this form:

    a_{ij} (b_{j-1} - a_{j,j-1}) = (a_{i,j-1} - a_{j,j-1}) b_j,
        i = 3..s,  j = 2..i-1.

Proposition 3.1: EES(2,5;x) and EES(2,7;x) are Williamson-2N for every
admissible x.  This module provides the closed-form coefficients (Appendix D),
conversions in both directions, and the Bazavov condition check.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "LowStorage",
    "EES25_2N",
    "EES27_2N",
    "ees25_2n",
    "bazavov_residuals",
    "butcher_from_2n",
    "two_n_from_butcher",
    "cf_weights",
]


@dataclasses.dataclass(frozen=True)
class LowStorage:
    """Williamson 2N coefficients.  ``A[0]`` must be 0.

    ``c`` are the stage abscissae of the equivalent Butcher tableau, needed to
    evaluate non-autonomous vector fields at the correct stage times.
    """

    name: str
    A: Tuple[float, ...]
    B: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int
    sym_order: int

    @property
    def stages(self) -> int:
        return len(self.B)


def ees25_2n(x: float = 0.1) -> LowStorage:
    """Williamson 2N coefficients of EES(2,5;x) (Appendix D).

    At x = 1/10: B = (1/3, 15/16, 2/5), A = (0, -7/15, -35/32).
    """
    if x in (1.0, 0.5, -0.5):
        raise ValueError(f"x={x} inadmissible")
    B1 = (2 * x + 1) / (4 * (1 - x))
    B2 = (1 - x) / (1 - 4 * x * x)
    B3 = (1 - 2 * x) / 2
    A2 = (4 * x * x - 2 * x + 1) / (2 * (x - 1))
    A3 = -(4 * x * x - 2 * x + 1) / ((2 * x - 1) ** 2 * (2 * x + 1))
    A = (0.0, A2, A3)
    B = (B1, B2, B3)
    a, b = butcher_from_2n(A, B)
    c = tuple(float(sum(row)) for row in a)
    return LowStorage(f"EES(2,5;{x:g})-2N", A, B, c, order=2, sym_order=5)


# EES(2,7) canonical member: x = (5 - 3 sqrt(2))/14, +sqrt(2) branch (Appendix D).
_S2 = math.sqrt(2.0)
_EES27_B = (
    (2.0 - _S2) / 3.0,
    (4.0 + _S2) / 8.0,
    3.0 * (3.0 - _S2) / 7.0,
    (9.0 - 4.0 * _S2) / 14.0,
)
_EES27_A = (
    0.0,
    (-7.0 + 4.0 * _S2) / 3.0,
    -(4.0 + 5.0 * _S2) / 12.0,
    3.0 * (-31.0 + 8.0 * _S2) / 49.0,
)


# ---------------------------------------------------------------------------
# Conversions.
# ---------------------------------------------------------------------------

def cf_weights(A: Sequence[float], B: Sequence[float]) -> np.ndarray:
    """Unrolled weight matrix ``beta[l, i] = B_l A_l A_{l-1} ... A_{i+1}`` (i<l),
    ``beta[l, l] = B_l`` — the coefficients of ``K_1..K_l`` inside the l-th
    exponential of the commutator-free lift (Proposition D.1)."""
    s = len(B)
    beta = np.zeros((s, s))
    for l in range(s):
        beta[l, l] = B[l]
        prod = B[l]
        for i in range(l - 1, -1, -1):
            prod = prod * A[i + 1]
            beta[l, i] = prod
    return beta


def butcher_from_2n(A: Sequence[float], B: Sequence[float]):
    """Reconstruct the Butcher tableau from Williamson 2N coefficients.

    ``a_{i,j} = sum_{l=j}^{i-1} beta_{l,j}``, ``b_j = sum_{l=j}^{s} beta_{l,j}``
    (telescoping of the 2N recurrence; the final row of Proposition D.1).
    """
    beta = cf_weights(A, B)
    s = len(B)
    a = [[0.0] * s for _ in range(s)]
    for i in range(1, s):
        for j in range(i):
            a[i][j] = float(beta[j:i, j].sum())
    b = tuple(float(beta[j:, j].sum()) for j in range(s))
    return tuple(tuple(row) for row in a), b


def bazavov_residuals(a: np.ndarray, b: np.ndarray) -> float:
    """Max |residual| of Bazavov's 2N-representability conditions (Theorem 3.1)."""
    s = len(b)
    worst = 0.0
    for i in range(2, s):  # i = 3..s, 0-indexed 2..s-1
        for j in range(1, i):  # j = 2..i-1, 0-indexed 1..i-1
            lhs = a[i][j] * (b[j - 1] - a[j][j - 1])
            rhs = (a[i][j - 1] - a[j][j - 1]) * b[j]
            worst = max(worst, abs(lhs - rhs))
    # Note: the analogous condition with b as the (s+1)-th row is an algebraic
    # identity, so only the interior conditions constrain the tableau.
    return worst


def two_n_from_butcher(a: np.ndarray, b: np.ndarray):
    """Solve for (A, B) from a 2N-representable Butcher tableau.

    B_l = a_{l+1,l} for l < s and B_s = b_s;
    A_l = (a_{l+1,l-1} - a_{l,l-1}) / B_l for l in 2..s-1, A_s = (b_{s-1} - a_{s,s-1}) / b_s.
    (Appendix D gives exactly this pattern for EES(2,7;x).)
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    s = len(b)
    B = [a[l + 1, l] for l in range(s - 1)] + [b[s - 1]]
    A = [0.0]
    for l in range(1, s - 1):  # stages 2..s-1 (1-indexed)
        A.append((a[l + 1, l - 1] - a[l, l - 1]) / B[l])
    A.append((b[s - 2] - a[s - 1, s - 2]) / b[s - 1])
    return tuple(float(x) for x in A), tuple(float(x) for x in B)


# Module-level canonical instances (defined after the conversion helpers).
EES25_2N = ees25_2n(0.1)


def _ees27() -> LowStorage:
    a, b = butcher_from_2n(_EES27_A, _EES27_B)
    c = tuple(float(sum(row)) for row in a)
    return LowStorage("EES(2,7)-2N", _EES27_A, _EES27_B, c, order=2, sym_order=7)


EES27_2N = _ees27()
