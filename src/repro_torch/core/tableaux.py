"""Butcher tableaux for explicit Runge-Kutta schemes (port of
``repro.core.tableaux``, the tableaux the solver registry needs).

A copy of the reference's definitions and its analysis helpers
``stability_poly`` and ``order_residuals`` (the reference module is not
imported: its package pulls in jax).  The
EES(n, m; x) schemes are explicit RK methods of order n whose composition
``Phi_{-h} o Phi_h`` recovers the initial condition up to order m.
EES(2,5;x) is the 3-stage family of Proposition 2.1 (canonical x = 1/10);
EES(2,7) is rebuilt from its Williamson 2N coefficients (Appendix D).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Tuple

import numpy as np

__all__ = [
    "Tableau",
    "ees25",
    "ees25_tableau",
    "ees27_tableau",
    "euler",
    "midpoint",
    "heun",
    "ralston3",
    "rk3",
    "rk4",
    "stability_poly",
    "order_residuals",
]


@dataclasses.dataclass(frozen=True)
class Tableau:
    """An explicit Butcher tableau.

    ``a`` is an (s, s) strictly-lower-triangular matrix, ``b`` the weights,
    ``c`` the abscissae.  ``order`` is the classical order, ``sym_order`` the
    effective-symmetry order m (``sym_order == order`` for schemes with no
    special symmetry property).
    """

    name: str
    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int
    sym_order: int

    @property
    def stages(self) -> int:
        return len(self.b)

    def a_np(self) -> np.ndarray:
        return np.array(self.a, dtype=np.float64)

    def b_np(self) -> np.ndarray:
        return np.array(self.b, dtype=np.float64)

    def c_np(self) -> np.ndarray:
        return np.array(self.c, dtype=np.float64)


def _tab(name, a, b, order, sym_order=None) -> Tableau:
    a = tuple(tuple(float(x) for x in row) for row in a)
    b = tuple(float(x) for x in b)
    c = tuple(float(sum(row)) for row in a)
    return Tableau(name, a, b, c, order, sym_order if sym_order is not None else order)


def ees25_tableau(x: float = 0.1) -> Tableau:
    """3-stage EES(2,5;x) Butcher tableau (paper, Proposition 2.1).

    Valid for x not in {1, 1/2, -1/2}.  The canonical member is x = 1/10.
    """
    if x in (1.0, 0.5, -0.5):
        raise ValueError(f"x={x} is not an admissible EES(2,5;x) parameter")
    xf = Fraction(x).limit_denominator(10**12)
    a21 = (1 + 2 * xf) / (4 * (1 - xf))
    a31 = (4 * xf - 1) ** 2 / (4 * (xf - 1) * (1 - 4 * xf**2))
    a32 = (1 - xf) / (1 - 4 * xf**2)
    b = (xf, Fraction(1, 2), Fraction(1, 2) - xf)
    a = ((0, 0, 0), (a21, 0, 0), (a31, a32, 0))
    return _tab(f"EES(2,5;{float(x):g})", a, b, order=2, sym_order=5)


#: Canonical EES(2,5) = EES(2,5; 1/10): a21 = 1/3, a31 = -5/48, a32 = 15/16,
#: b = (1/10, 1/2, 2/5), c = (0, 1/3, 5/6).
ees25 = ees25_tableau(0.1)


def ees27_tableau() -> Tableau:
    """Canonical 4-stage EES(2,7) tableau, rebuilt exactly from the Williamson
    2N coefficients of Appendix D."""
    from .williamson import EES27_2N, butcher_from_2n

    a, b = butcher_from_2n(EES27_2N.A, EES27_2N.B)
    return _tab("EES(2,7)", a, b, order=2, sym_order=7)


euler = _tab("Euler", ((0,),), (1,), order=1)
midpoint = _tab("Midpoint", ((0, 0), (0.5, 0)), (0, 1), order=2)
heun = _tab("Heun", ((0, 0), (1, 0)), (0.5, 0.5), order=2)
ralston3 = _tab(
    "Ralston3",
    ((0, 0, 0), (0.5, 0, 0), (0, 0.75, 0)),
    (Fraction(2, 9), Fraction(1, 3), Fraction(4, 9)),
    order=3,
)
rk3 = _tab(
    "RK3",
    ((0, 0, 0), (0.5, 0, 0), (-1, 2, 0)),
    (Fraction(1, 6), Fraction(2, 3), Fraction(1, 6)),
    order=3,
)
rk4 = _tab(
    "RK4",
    ((0, 0, 0, 0), (0.5, 0, 0, 0), (0, 0.5, 0, 0), (0, 0, 1, 0)),
    (Fraction(1, 6), Fraction(1, 3), Fraction(1, 3), Fraction(1, 6)),
    order=4,
)


def stability_poly(tab: Tableau) -> np.ndarray:
    """Coefficients (ascending) of the linear stability polynomial R(rho):
    ``R(rho) = 1 + sum_k (b^T A^k 1) rho^{k+1}``.  EES(2,5;x) yields
    ``1 + rho + rho^2/2 + rho^3/8`` independently of x (Theorem 2.2)."""
    A, b = tab.a_np(), tab.b_np()
    coeffs = [1.0]
    vec = np.ones(tab.stages)
    for _ in range(tab.stages):
        coeffs.append(float(b @ vec))
        vec = A @ vec
    return np.array(coeffs)


def order_residuals(tab: Tableau, up_to: int = 3) -> dict:
    """Residuals of the rooted-tree order conditions up to order ``up_to`` (<=4)."""
    A, b, c = tab.a_np(), tab.b_np(), tab.c_np()
    res = {}
    if up_to >= 1:
        res["t1"] = abs(b.sum() - 1.0)
    if up_to >= 2:
        res["t2"] = abs(b @ c - 0.5)
    if up_to >= 3:
        res["t31"] = abs(b @ c**2 - 1.0 / 3.0)
        res["t32"] = abs(b @ (A @ c) - 1.0 / 6.0)
    if up_to >= 4:
        res["t41"] = abs(b @ c**3 - 0.25)
        res["t42"] = abs((b * c) @ (A @ c) - 1.0 / 8.0)
        res["t43"] = abs(b @ (A @ c**2) - 1.0 / 12.0)
        res["t44"] = abs(b @ (A @ A @ c) - 1.0 / 24.0)
    return res
