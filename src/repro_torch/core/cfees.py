"""CF-EES: commutator-free EES integrators on homogeneous spaces, plus the
geometric baselines (geometric Euler-Maruyama, Crouch-Grossman CG2, RKMK2).

Port of ``repro.core.cfees``.  One CF-EES step (eq. (4)/(16)) from ``y_n``
with driver increment ``dX = (h, dW)``::

    Y_0 = y_n,  delta_0 = 0
    K_l     = xi(Y_{l-1}) . dX                      (algebra increment)
    delta_l = A_l delta_{l-1} + K_l
    Y_l     = Lambda(exp(B_l delta_l), Y_{l-1}),    l = 1..s

Only ``(Y, delta)`` are live — the two-register Williamson pattern — and the
step costs exactly ``s`` vector-field evaluations and ``s`` exponentials
(Table 5: the 2N-CF optimum).  The reverse step is the same recurrence with
``(h, dW) -> (-h, -dW)``; by Theorem 3.2 it recovers ``y_n`` to order 5 (or 7),
which is what the reversible adjoint (Algorithm 2) consumes: the port's
``solve`` takes these solvers under all three adjoints, tuple (product
group) states included.

On :class:`~repro_torch.core.lie.Euclidean` the action is translation and
the step is *identically* the port's Euclidean 2N EES step (plain route),
bit for bit.
"""
from __future__ import annotations

from typing import Optional

from .lie import ManifoldSDETerm
from .pytree import tree_axpy, tree_scale
from .williamson import EES25_2N, EES27_2N, LowStorage

__all__ = [
    "CFLowStorageSolver",
    "GeoEulerMaruyama",
    "CrouchGrossman2",
    "RKMK2",
    "cfees25_solver",
    "cfees27_solver",
]


class _Geometric:
    """The state is the point itself; the reverse step negates the driver."""

    def init(self, term, t0, y0, args):
        return y0

    def extract(self, state):
        return state

    def reverse(self, term, state, t, h, dW, args):
        return self.step(term, state, t + h, -h, tree_scale(-1.0, dW), args)


class CFLowStorageSolver(_Geometric):
    """CF-EES(2,m;x): Bazavov's 2N commutator-free lift of a Williamson scheme."""

    def __init__(self, ls: LowStorage, name: Optional[str] = None):
        self.ls = ls
        self.name = name or ls.name.replace("EES", "CF-EES")
        self.evals_per_step = ls.stages
        self.exps_per_step = ls.stages
        self.is_reversible = ls.sym_order > ls.order

    def step(self, term: ManifoldSDETerm, state, t, h, dW, args):
        ls = self.ls
        y = state
        delta = None
        for l in range(ls.stages):
            k = term.algebra_increment(t + ls.c[l] * h, y, args, h, dW)
            delta = k if delta is None else tree_axpy(ls.A[l], delta, k)
            y = term.group.exp_action(tree_scale(ls.B[l], delta), y)
        return y


class GeoEulerMaruyama(_Geometric):
    """Geometric Euler-Maruyama: y' = Lambda(exp(xi(y).dX), y).  Order 1 weak.
    Its reverse is only first-order accurate: GeoEM is not effectively
    symmetric."""

    name = "GeoEM"
    evals_per_step = 1
    exps_per_step = 1
    is_reversible = False

    def step(self, term, state, t, h, dW, args):
        inc = term.algebra_increment(t, state, args, h, dW)
        return term.group.exp_action(inc, state)


class CrouchGrossman2(_Geometric):
    """CG2 (explicit midpoint Crouch-Grossman): 2 evals, 2 exponentials."""

    name = "CG2"
    evals_per_step = 2
    exps_per_step = 2
    is_reversible = False

    def step(self, term, state, t, h, dW, args):
        k1 = term.algebra_increment(t, state, args, h, dW)
        y_mid = term.group.exp_action(tree_scale(0.5, k1), state)
        k2 = term.algebra_increment(t + 0.5 * h, y_mid, args, h, dW)
        return term.group.exp_action(k2, state)


class RKMK2(_Geometric):
    """RKMK trapezoidal rule of order 2 (dexpinv truncation is exact at this
    order, so no commutators appear): one exponential of the averaged slopes."""

    name = "RKMK2"
    evals_per_step = 2
    exps_per_step = 2
    is_reversible = False

    def step(self, term, state, t, h, dW, args):
        k1 = term.algebra_increment(t, state, args, h, dW)
        y1 = term.group.exp_action(k1, state)
        k2 = term.algebra_increment(t + h, y1, args, h, dW)
        avg = tree_scale(0.5, tree_axpy(1.0, k1, k2))
        return term.group.exp_action(avg, state)


def cfees25_solver(x: float = 0.1) -> CFLowStorageSolver:
    if x == 0.1:
        return CFLowStorageSolver(EES25_2N, name="CF-EES(2,5)")
    from .williamson import ees25_2n

    return CFLowStorageSolver(ees25_2n(x))


def cfees27_solver() -> CFLowStorageSolver:
    return CFLowStorageSolver(EES27_2N, name="CF-EES(2,7)")
