"""Euclidean SDE terms and solvers: EES Runge-Kutta (Butcher and Williamson
2N forms), Reversible Heun, McCallum-Foster reversible couplings and the
noise-specialised schemes (Milstein, SRA1).

Port of ``repro.core.solvers``: :class:`SDETerm` (five noise modes, same
validation messages), the prediffused additive term the solve loop builds
(:class:`_PrediffusedTerm`), :class:`ButcherSolver`,
:class:`LowStorageSolver`, :class:`ReversibleHeun`, :class:`MCFSolver`,
:class:`Milstein`, :class:`SRKAdditive` and the ``ees25_solver`` /
``ees27_solver`` factories.  Every solver has the reference's interface
(``init`` / ``step`` / ``reverse`` / ``extract``).

SDEs ``dy = f(y) dt + g(y) o dW`` are stepped as RDEs driven by
``X = (t, W)``: the tableau is applied to the increment
``F(t, y).dX = f(t, y) h + g(t, y).dW``.  The port writes the path batch
out as leading state axes, so drift and diffusion receive batched states.

``use_kernels=True`` keeps the reference's routing: the 2N solver runs each
diagonal/additive, general or prediffused stage through the matching fused
:mod:`repro_torch.kernels.sde_step` stage kernel (scalar noise and ODE
stages form ``k`` in plain torch and update the registers with
:mod:`repro_torch.kernels.williamson2n`); the other solvers form their
increments with the ``increment_diag`` / ``increment_general`` /
``increment_pre`` kernels and Butcher stage combinations with the
``axpy_chain`` kernel.  The default path is plain torch: bitwise equal to
the kernel route for diagonal, additive and prediffused noise, and equal to
rounding for general noise (its kernels sum ``g@dW`` in another order than
``torch.einsum``).
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
    "Milstein",
    "SRKAdditive",
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
        ``increment_diag`` kernel (bitwise equal to the plain path) and
        general noise through ``increment_general`` (equal to rounding: the
        plain path's einsum sums in another order).  Scalar noise and ODE
        mode stay on the plain path, as in the reference.
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


@dataclasses.dataclass(frozen=True)
class _PrediffusedTerm:
    """An additive-noise term whose diffusion increments were pre-weighted.

    Built by :func:`repro_torch.core.adjoint.solve` when an ``"additive"``
    term meets the bulk increment buffer under the full adjoint: the whole
    ``w = g*dW`` buffer is formed once per solve (``g`` does not depend on
    ``t`` or ``y``), and each step's ``dW`` is already ``w``, so ``combine``
    is ``f*h + w`` — one operand stream fewer per stage (the ``prediffused``
    kernels).  Bitwise equal to the diagonal route: ``g*dW`` is the same
    multiply, hoisted out of the loop.
    """

    base: SDETerm
    noise: str = "prediffused"

    @property
    def drift(self):
        return self.base.drift

    def evals(self, t, y, args):
        f = self.base.drift(t, y, args)
        # A placeholder diffusion: ``combine`` and the kernels never read it,
        # but Reversible Heun carries g in its state and the 2N solver gates
        # its fused path on ``g is None``.
        return f, tree_map(torch.ones_like, f)

    def combine(self, f, g, h, dW, use_kernels: bool = False):
        if use_kernels:
            return _fused_ops.tree_increment(f, None, dW, h, noise="prediffused")
        return tree_map(lambda fi, wi: fi * h + wi, f, dW)

    def increment(self, t, y, args, h, dW, use_kernels: bool = False):
        f = self.base.drift(t, y, args)
        return self.combine(f, None, h, dW, use_kernels=use_kernels)


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

    ``use_kernels=True`` fuses each diagonal/additive, general or
    prediffused stage (increment and the two-register update) into one CUDA
    kernel pass; stages with no fused noise take the precomputed-``k``
    ``williamson2n`` kernel.
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
        elimination to drop it from plain steps.  A fused last stage forms
        it as the plain path does (``f*h + g.dW``), where the reference
        recovers it as ``delta' - A*delta``: the estimate, and so every
        accept decision of an adaptive solve, then equals the plain path's
        bitwise.
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
                    delta, y = _fused_ops.tree_ws_stage(
                        delta, y, f, g, dW, h, ls.A[l], ls.B[l], noise=noise)
                    if need_k and l == ls.stages - 1:
                        k = term.combine(f, g, h, dW)
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


class Milstein:
    """Milstein's method: Euler-Maruyama plus the first-order noise correction.

        y' = y + f h + g dW + (1/2) (g . grad g) (dW^2 - h)     [Ito]
        y' = y + f h + g dW + (1/2) (g . grad g) dW^2           [Stratonovich]

    ``g . grad g`` is computed exactly with one ``torch.func.jvp`` of the
    diffusion at tangent ``g`` (the reference's ``jax.jvp``).  Strong order 1
    for scalar noise, for diagonal noise whose channels are componentwise,
    and for additive noise (the correction vanishes); general noise needs
    Levy areas and is rejected at ``init``.  ``reverse`` subtracts the full
    increment evaluated at the step's endpoint (O(h^{3/2}) per step).
    """

    evals_per_step = 2
    is_reversible = False
    # Reads term.diffusion directly (for the jvp): opts out of the
    # prediffused additive fast path (adjoint._maybe_prediffuse).
    needs_diffusion = True
    strong_orders = {"diagonal": 1.0, "scalar": 1.0, "additive": 1.0}

    def __init__(self, form: str = "ito", use_kernels: bool = False):
        if form not in ("ito", "stratonovich"):
            raise ValueError(
                f"unknown Milstein form {form!r}; valid forms: 'ito', "
                "'stratonovich'"
            )
        self.form = form
        self.sde_form = form
        self.name = f"Milstein-{form}"
        self.use_kernels = bool(use_kernels)

    def init(self, term, t0, y0, args):
        noise = getattr(term, "noise", "diagonal")
        if noise not in ("none", "diagonal", "additive", "scalar"):
            raise ValueError(
                f"Milstein does not support noise={noise!r}: general "
                "(non-commutative) noise needs full Levy areas; supported "
                "modes: 'diagonal', 'additive', 'scalar', 'none'"
            )
        return y0

    def extract(self, state):
        return state

    def _correction(self, term, t, y, g, h, dW, args):
        """(1/2) (g . grad g) (dW^2 [- h]) as a pytree increment."""
        _, gdg = torch.func.jvp(lambda yy: term.diffusion(t, yy, args),
                                (y,), (g,))
        if getattr(term, "noise", "diagonal") == "scalar":
            def w2(like):  # one channel per path, broadcast over the leaf
                w = _per_path(dW, like)
                return w * w - h if self.form == "ito" else w * w

            return tree_map(lambda d: 0.5 * d * w2(d), gdg)
        if self.form == "ito":
            return tree_map(lambda d, w: 0.5 * d * (w * w - h), gdg, dW)
        return tree_map(lambda d, w: 0.5 * d * (w * w), gdg, dW)

    def _increment(self, term, y, t, h, dW, args):
        f, g = term.evals(t, y, args)
        inc = term.combine(f, g, h, dW, use_kernels=self.use_kernels)
        if g is None:
            return inc
        return tree_add(inc, self._correction(term, t, y, g, h, dW, args))

    def step(self, term, state, t, h, dW, args):
        return tree_add(state, self._increment(term, state, t, h, dW, args))

    def step_with_error(self, term, state, t, h, dW, args):
        """Milstein step with the correction as the embedded error estimate
        (the difference from the order-1/2 Euler companion)."""
        f, g = term.evals(t, state, args)
        out = tree_add(state, term.combine(f, g, h, dW,
                                           use_kernels=self.use_kernels))
        if g is None:
            return out, tree_zeros_like(out)
        corr = self._correction(term, t, state, g, h, dW, args)
        return tree_add(out, corr), corr

    def reverse(self, term, state, t, h, dW, args):
        # Subtract the increment re-evaluated at the endpoint (time t + h).
        return tree_sub(state, self._increment(term, state, t + h, h, dW, args))


class SRKAdditive:
    """SRA1 (Roessler 2010): strong order 1.5 for additive noise.

    Two drift stages plus the space-time Levy area ``DH``::

        k1 = f(t, y)
        y2 = y + (3/4) h k1 + (3/2) g (DH + DW/2)
        y' = y + h (k1/3 + 2 k2/3) + g DW,     k2 = f(t + 3h/4, y2)

    The driver increment is the pair ``(dW, dH)`` (solvers advertising
    ``needs_levy_area`` get it from the Levy-augmented driver queries, in
    bulk and per step, forward and in the reversible replay).  ``reverse``
    replays with the whole pair negated.
    """

    name = "SRA1"
    evals_per_step = 2
    is_reversible = False
    needs_levy_area = True
    # Reads term.diffusion directly: opts out of the prediffused fast path.
    needs_diffusion = True
    sde_form = "ito"  # == stratonovich: additive noise has no correction
    strong_orders = {"additive": 1.5}

    def __init__(self, noise: str = "additive"):
        if noise != "additive":
            raise ValueError(
                f"srk supports noise='additive' only (t/y-independent "
                f"diffusion), got noise={noise!r}"
            )

    def init(self, term, t0, y0, args):
        noise = getattr(term, "noise", "diagonal")
        if noise != "additive":
            raise ValueError(
                f"SRA1 requires an SDETerm with noise='additive', got "
                f"noise={noise!r} — declare the term additive (diffusion "
                "independent of t and y) or pick another solver"
            )
        return y0

    def extract(self, state):
        return state

    def step(self, term, state, t, h, dW_pair, args):
        dW, dH = dW_pair
        y = state
        k1 = term.drift(t, y, args)
        g = term.diffusion(t, y, args)
        # DZ/h = dH + dW/2 (exact scalar weights; no h division).
        y2 = tree_map(
            lambda yi, ki, gi, wi, hi: yi + 0.75 * h * ki
            + 1.5 * gi * (hi + 0.5 * wi),
            y, k1, g, dW, dH)
        k2 = term.drift(t + 0.75 * h, y2, args)
        third = 1.0 / 3.0
        return tree_map(
            lambda yi, a, b, gi, wi: yi + h * (third * a + 2.0 * third * b)
            + gi * wi,
            y, k1, k2, g, dW)

    def step_with_error(self, term, state, t, h, dW_pair, args):
        """SRA1 step with its Euler companion as the embedded estimate."""
        dW, _ = dW_pair
        out = self.step(term, state, t, h, dW_pair, args)
        f, g = term.evals(t, state, args)
        y_low = tree_add(state, term.combine(f, g, h, dW))
        return out, tree_sub(out, y_low)

    def reverse(self, term, state, t, h, dW_pair, args):
        return self.step(term, state, t + h, -h, tree_scale(-1.0, dW_pair), args)


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
