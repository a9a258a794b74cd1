"""Euclidean SDE terms and solvers: EES Runge-Kutta (Butcher and Williamson
2N forms), Reversible Heun and McCallum-Foster reversible couplings.

Port of ``repro.core.solvers`` without the noise-specialised schemes
(Milstein, SRA1), which come in a later slice: :class:`SDETerm` (five noise
modes, same validation messages), :class:`ButcherSolver`,
:class:`LowStorageSolver`, :class:`ReversibleHeun`, :class:`MCFSolver` and
the ``ees25_solver`` / ``ees27_solver`` factories.  Every solver has the
reference's interface (``init`` / ``step`` / ``reverse`` / ``extract``).

SDEs ``dy = f(y) dt + g(y) o dW`` are stepped as RDEs driven by
``X = (t, W)``: the tableau is applied to the increment
``F(t, y).dX = f(t, y) h + g(t, y).dW``.  The port writes the path batch
out as leading state axes, so drift and diffusion receive batched states.

``use_kernels=True`` keeps the reference's routing: the 2N solver runs each
diagonal/additive stage through the fused :mod:`repro_torch.kernels.sde_step`
stage kernel (scalar noise and ODE stages form ``k`` in plain torch and
update the registers with :mod:`repro_torch.kernels.williamson2n`); the
other solvers form diagonal/additive increments with the ``increment_diag``
kernel and Butcher stage combinations with the ``axpy_chain`` kernel.  The
default path is plain torch, bitwise equal to the kernel route.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..kernels.sde_step import ops as _fused_ops
from ..kernels.williamson2n.ops import williamson2n_update as _williamson2n_update
from .pytree import (flatten_up_to, tree_add, tree_axpy, tree_flatten, tree_map,
                     tree_scale, tree_sub, tree_unflatten, tree_zeros_like)
from .tableaux import Tableau
from .williamson import EES25_2N, EES27_2N, LowStorage

__all__ = [
    "SDETerm",
    "VALID_NOISE",
    "ButcherSolver",
    "LowStorageSolver",
    "ReversibleHeun",
    "MCFSolver",
    "ees25_solver",
    "ees27_solver",
]


def _rk_strong_orders(b, c):
    """Documented strong orders of a driver-weighted RK scheme, from ``b.c``:
    0 gives the Ito limit (Euler rates), 1/2 the Stratonovich one (strong
    order 1 for commutative noise)."""
    bc = float(sum(bi * ci for bi, ci in zip(b, c)))
    if abs(bc - 0.5) < 1e-12:
        return "stratonovich", {"diagonal": 1.0, "scalar": 1.0,
                                "additive": 1.0, "general": 0.5}
    if bc == 0.0:
        return "ito", {"diagonal": 0.5, "scalar": 0.5,
                       "additive": 1.0, "general": 0.5}
    return None, {"diagonal": 0.5, "scalar": 0.5,
                  "additive": 1.0, "general": 0.5}


def _resolve_use_kernels(use_kernels, use_kernel):
    """One boolean from the current flag and its legacy spelling: an
    explicitly-set ``use_kernels`` wins; ``use_kernel`` applies only when
    the new flag was left at its ``None`` default."""
    if use_kernels is not None:
        return bool(use_kernels)
    if use_kernel is not None:
        return bool(use_kernel)
    return False


#: Noise structures an :class:`SDETerm` may declare.
VALID_NOISE = ("none", "diagonal", "additive", "scalar", "general")


def _per_path(dW, like):
    """A scalar-noise increment against a state leaf: ``dW`` holds one value
    per path (shape = the leading batch axes, ``()`` for one path), so it
    gains trailing unit axes to broadcast over the leaf's state axes."""
    if not isinstance(dW, torch.Tensor) or dW.dim() == 0:
        return dW
    return dW.reshape(tuple(dW.shape) + (1,) * (like.dim() - dW.dim()))


@dataclasses.dataclass(frozen=True)
class SDETerm:
    """Drift + diffusion with a declared noise structure.

    noise:
      * "none"     — ODE; ``diffusion`` is ignored.
      * "diagonal" — ``diffusion`` matches ``y``'s pytree; the product with
        ``dW`` is elementwise.
      * "additive" — diagonal arithmetic, with the contract that the
        diffusion does not depend on ``t`` or ``y``.
      * "scalar"   — one Brownian channel shared by every state component.
      * "general"  — state ``(..., d)``, diffusion ``(..., d, m)``, ``dW``
        ``(..., m)``.
    """

    drift: Callable[..., Any]
    diffusion: Optional[Callable[..., Any]] = None
    noise: str = "diagonal"

    def __post_init__(self):
        if self.noise not in VALID_NOISE:
            raise ValueError(
                f"unknown noise mode {self.noise!r} for SDETerm; valid modes: "
                + ", ".join(repr(n) for n in VALID_NOISE)
            )
        if self.noise != "none" and self.diffusion is None:
            raise ValueError(
                f"SDETerm(noise={self.noise!r}) requires a diffusion callable; "
                "only noise='none' (ODE mode) may omit it"
            )

    def evals(self, t, y, args):
        """Vector-field evaluation, returned as a (f, g) pair."""
        f = self.drift(t, y, args)
        g = None if self.noise == "none" else self.diffusion(t, y, args)
        return f, g

    def combine(self, f, g, h, dW, use_kernels: bool = False):
        """f * h + g . dW  (the driver-weighted increment).

        ``use_kernels=True`` routes diagonal and additive noise through the
        ``increment_diag`` kernel (bitwise equal to the plain path); general
        noise names its TPU kernel, still to port, and raises.  Scalar noise
        and ODE mode stay on the plain path, as in the reference.
        """
        if self.noise == "none" or g is None:
            return tree_scale(h, f)
        if use_kernels and self.noise in ("diagonal", "additive", "general"):
            kernel_noise = "diagonal" if self.noise == "additive" else self.noise
            return _fused_ops.tree_increment(f, g, dW, h, noise=kernel_noise)
        out = tree_scale(h, f)
        if self.noise in ("diagonal", "additive"):
            return tree_map(lambda o, gi, wi: o + gi * wi, out, g, dW)
        if self.noise == "scalar":
            return tree_map(lambda o, gi: o + gi * _per_path(dW, gi), out, g)
        return tree_map(
            lambda o, gi, wi: o + torch.einsum("...dm,...m->...d", gi, wi),
            out, g, dW)

    def increment(self, t, y, args, h, dW, use_kernels: bool = False):
        f, g = self.evals(t, y, args)
        return self.combine(f, g, h, dW, use_kernels=use_kernels)


class ButcherSolver:
    """Classical (s+1)N-register explicit RK applied to the (h, dW) driver.

    ``use_kernels=True`` forms each stage increment with the
    ``increment_diag`` kernel and each a/b-row combination with one
    ``axpy_chain`` kernel pass (bitwise equal to the plain ``tree_axpy``
    chain, which accumulates in the same order).
    """

    def __init__(self, tab: Tableau, use_kernels: bool = False):
        self.tab = tab
        self.name = tab.name
        self.evals_per_step = tab.stages
        self.is_reversible = tab.sym_order > tab.order
        self.use_kernels = bool(use_kernels)
        self.sde_form, self.strong_orders = _rk_strong_orders(tab.b, tab.c)

    def init(self, term, t0, y0, args):
        return y0

    def extract(self, state):
        return state

    def _weighted(self, y, incrs, coeffs):
        """y + sum_i coeffs[i] * incrs[i], skipping zero coefficients."""
        live = [(c, k) for c, k in zip(coeffs, incrs) if c != 0.0]
        if not live:
            return y
        if self.use_kernels:
            return _fused_ops.tree_axpy_chain(
                y, [k for _, k in live], [c for c, _ in live])
        for c, k in live:
            y = tree_axpy(c, k, y)
        return y

    def _stages(self, term, state, t, h, dW, args):
        """Run the stage loop once; return (y_next, stage increments)."""
        tab = self.tab
        y = state
        incrs = []
        for i in range(tab.stages):
            yi = self._weighted(y, incrs, tab.a[i][:i])
            incrs.append(term.increment(t + tab.c[i] * h, yi, args, h, dW,
                                        use_kernels=self.use_kernels))
        return self._weighted(y, incrs, tab.b), incrs

    def step(self, term, state, t, h, dW, args):
        return self._stages(term, state, t, h, dW, args)[0]

    def step_with_error(self, term, state, t, h, dW, args):
        """One step plus the embedded first-order estimate: the Euler step
        built from the first stage increment, ``err = y_high - y_euler``."""
        if self.tab.stages < 2:
            raise ValueError(
                f"{self.name} has a single stage: the high- and low-order "
                "solutions coincide, so there is no embedded error estimate "
                "(pick a >=2-stage scheme for adaptive stepping)"
            )
        out, incrs = self._stages(term, state, t, h, dW, args)
        return out, tree_sub(out, tree_add(state, incrs[0]))

    def reverse(self, term, state, t, h, dW, args):
        # Near-reversible reconstruction: the same scheme with negated driver
        # increments, started from the end of the step (time t + h).
        return self.step(term, state, t + h, -h, tree_scale(-1.0, dW), args)


class LowStorageSolver:
    """Two-register Williamson form (eq. (2)): the paper's memory-optimal EES.

    ``use_kernels=True`` fuses each diagonal-noise stage (increment and the
    two-register update) into one CUDA kernel pass; stages with no fused
    noise take the precomputed-``k`` ``williamson2n`` kernel.
    """

    def __init__(self, ls: LowStorage, use_kernels: Optional[bool] = None,
                 use_kernel: Optional[bool] = None):
        self.ls = ls
        self.name = ls.name
        self.evals_per_step = ls.stages
        self.is_reversible = ls.sym_order > ls.order
        self.use_kernels = _resolve_use_kernels(use_kernels, use_kernel)
        self.sde_form = "stratonovich"
        self.strong_orders = {"diagonal": 1.0, "scalar": 1.0,
                              "additive": 1.0, "general": 0.5}

    def init(self, term, t0, y0, args):
        return y0

    def extract(self, state):
        return state

    def _update(self, a, b, delta, k, y):
        """delta' = a*delta + k ; y' = y + b*delta'  (optionally fused)."""
        if self.use_kernels:
            d_leaves, treedef = tree_flatten(delta)
            pairs = [
                _williamson2n_update(d, kk, yy, a, b)
                for d, kk, yy in zip(d_leaves, flatten_up_to(treedef, k),
                                     flatten_up_to(treedef, y))
            ]
            return (tree_unflatten(treedef, [p[0] for p in pairs]),
                    tree_unflatten(treedef, [p[1] for p in pairs]))
        delta2 = tree_axpy(a, delta, k)
        y2 = tree_axpy(b, delta2, y)
        return delta2, y2

    def _sweep(self, term, state, t, h, dW, args, need_k: bool = False):
        """Run the 2N recurrence once; return ``(y_next, Y_{s-1}, K_s)``.

        ``K_s`` (the last stage increment, for the embedded estimator) is
        formed only when ``need_k``: eager torch has no dead-code
        elimination to drop it from plain steps.
        """
        ls = self.ls
        noise = getattr(term, "noise", "diagonal")
        if noise == "additive":
            noise = "diagonal"
        fused = self.use_kernels and noise in ("diagonal", "general",
                                               "prediffused")
        y = state
        delta = tree_zeros_like(y)
        y_prev = y
        k = None
        for l in range(ls.stages):
            y_prev = y
            if fused:
                f, g = term.evals(t + ls.c[l] * h, y, args)
                if g is None:
                    fused = False  # declared noise but no diffusion
                else:
                    delta_prev = delta
                    delta, y = _fused_ops.tree_ws_stage(
                        delta, y, f, g, dW, h, ls.A[l], ls.B[l], noise=noise)
                    if need_k:
                        k = tree_axpy(-ls.A[l], delta_prev, delta)
                    continue
            k = term.increment(t + ls.c[l] * h, y, args, h, dW,
                               use_kernels=self.use_kernels)
            delta, y = self._update(ls.A[l], ls.B[l], delta, k, y)
        return y, y_prev, k

    def step(self, term, state, t, h, dW, args):
        return self._sweep(term, state, t, h, dW, args)[0]

    def step_with_error(self, term, state, t, h, dW, args):
        """One 2N step plus the Appendix-D embedded first-order estimate::

            y_low = Y_{s-1} + (1 - c_s) * K_s,      err = y_{n+1} - y_low.
        """
        y, y_prev, k_last = self._sweep(term, state, t, h, dW, args,
                                        need_k=True)
        c_last = self.ls.c[self.ls.stages - 1]
        y_low = tree_axpy(1.0 - c_last, k_last, y_prev)
        err = tree_sub(y, y_low)
        return y, err

    def reverse(self, term, state, t, h, dW, args):
        return self.step(term, state, t + h, -h, tree_scale(-1.0, dW), args)


class ReversibleHeun:
    """Algebraically reversible two-state Heun; one (f, g) evaluation per step.

    State: (y, yhat, f(t, yhat), g(t, yhat)).  Stability region is the segment
    lambda*h in [-i, i] (Theorem 2.1) — the instability the EES schemes fix.
    ``use_kernels=True`` forms both increments with the ``increment_diag``
    kernel; reversibility needs only ``combine(-h, -dW) == -combine(h, dW)``,
    which holds exactly there too.
    """

    name = "ReversibleHeun"
    evals_per_step = 1
    is_reversible = True
    sde_form = "stratonovich"
    strong_orders = {"diagonal": 1.0, "scalar": 1.0,
                     "additive": 1.0, "general": 0.5}

    def __init__(self, use_kernels: bool = False):
        self.use_kernels = bool(use_kernels)

    def init(self, term, t0, y0, args):
        f, g = term.evals(t0, y0, args)
        if g is None:
            g = tree_zeros_like(f)
        return (y0, y0, f, g)

    def extract(self, state):
        return state[0]

    def step(self, term, state, t, h, dW, args):
        y, yh, fh, gh = state
        inc_prev = term.combine(fh, gh, h, dW, use_kernels=self.use_kernels)
        yh2 = tree_add(tree_sub(tree_scale(2.0, y), yh), inc_prev)
        f2, g2 = term.evals(t + h, yh2, args)
        if g2 is None:
            g2 = tree_zeros_like(f2)
        inc_next = term.combine(f2, g2, h, dW, use_kernels=self.use_kernels)
        y2 = tree_axpy(0.5, tree_add(inc_prev, inc_next), y)
        return (y2, yh2, f2, g2)

    def reverse(self, term, state, t, h, dW, args):
        # Exact: the scheme is its own inverse under (h, dW) -> (-h, -dW).
        return self.step(term, state, t + h, -h, tree_scale(-1.0, dW), args)


class MCFSolver:
    """Reversible coupling of an arbitrary base RK method (McCallum & Foster).

        y' = lam*y + (1-lam)*z + Psi_{dX}(z)
        z' = z - Psi_{-dX}(y')

    with exact algebraic inverse.  ``Psi_dX`` is the base-method increment over
    the driver increment dX = (h, dW).  Costs 2x the base stages per step.
    """

    def __init__(self, base: Tableau, lam: float = 0.999,
                 name: Optional[str] = None, use_kernels: bool = False):
        self.base = ButcherSolver(base, use_kernels=use_kernels)
        self.lam = lam
        self.name = name or f"MCF-{base.name}"
        self.evals_per_step = 2 * base.stages
        self.is_reversible = True
        self.use_kernels = self.base.use_kernels
        self.sde_form = self.base.sde_form
        self.strong_orders = self.base.strong_orders

    def _psi(self, term, z, t, h, dW, args):
        return tree_sub(self.base.step(term, z, t, h, dW, args), z)

    def init(self, term, t0, y0, args):
        return (y0, y0)

    def extract(self, state):
        return state[0]

    def step(self, term, state, t, h, dW, args):
        y, z = state
        lam = self.lam
        y2 = tree_add(
            tree_axpy(lam, y, tree_scale(1.0 - lam, z)),
            self._psi(term, z, t, h, dW, args),
        )
        ndW = tree_scale(-1.0, dW)
        z2 = tree_sub(z, self._psi(term, y2, t + h, -h, ndW, args))
        return (y2, z2)

    def reverse(self, term, state, t, h, dW, args):
        y2, z2 = state
        lam = self.lam
        ndW = tree_scale(-1.0, dW)
        z = tree_add(z2, self._psi(term, y2, t + h, -h, ndW, args))
        y = tree_scale(
            1.0 / lam,
            tree_sub(
                tree_sub(y2, tree_scale(1.0 - lam, z)),
                self._psi(term, z, t, h, dW, args),
            ),
        )
        return (y, z)


def ees25_solver(x: float = 0.1, use_kernels: Optional[bool] = None,
                 use_kernel: Optional[bool] = None) -> LowStorageSolver:
    if x == 0.1:
        return LowStorageSolver(EES25_2N, use_kernels=use_kernels,
                                use_kernel=use_kernel)
    from .williamson import ees25_2n

    return LowStorageSolver(ees25_2n(x), use_kernels=use_kernels,
                            use_kernel=use_kernel)


def ees27_solver(use_kernels: Optional[bool] = None,
                 use_kernel: Optional[bool] = None) -> LowStorageSolver:
    return LowStorageSolver(EES27_2N, use_kernels=use_kernels,
                            use_kernel=use_kernel)
