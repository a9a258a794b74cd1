"""Euclidean SDE terms and the EES Williamson 2N solver.

Port of the slice of ``repro.core.solvers`` that serves EES(2,5) and
EES(2,7): :class:`SDETerm` (five noise modes, same validation messages),
:class:`LowStorageSolver` (``step`` / ``reverse`` / ``step_with_error``) and
the ``ees25_solver`` / ``ees27_solver`` factories.  The other schemes
(Butcher RK, Reversible Heun, MCF, Milstein, SRA1) come in later slices.

SDEs ``dy = f(y) dt + g(y) o dW`` are stepped as RDEs driven by
``X = (t, W)``: the tableau is applied to the increment
``F(t, y).dX = f(t, y) h + g(t, y).dW``.  The port writes the path batch
out as leading state axes, so drift and diffusion receive batched states.

``use_kernels=True`` keeps the reference's stage routing (``_sweep``):
diagonal and additive noise run each stage through the fused
:mod:`repro_torch.kernels.sde_step` kernel; scalar noise and ODE stages
form ``k`` in plain torch and update the registers with
:mod:`repro_torch.kernels.williamson2n`.  The default path is the plain
torch recurrence.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..kernels.sde_step import ops as _fused_ops
from ..kernels.williamson2n.ops import williamson2n_update as _williamson2n_update
from .pytree import (flatten_up_to, tree_axpy, tree_flatten, tree_map,
                     tree_scale, tree_sub, tree_unflatten, tree_zeros_like)
from .williamson import EES25_2N, EES27_2N, LowStorage

__all__ = [
    "SDETerm",
    "VALID_NOISE",
    "LowStorageSolver",
    "ees25_solver",
    "ees27_solver",
]


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

_UNPORTED_INCREMENT = {
    "diagonal": "sde_step.py::increment_diag_2d",
    "additive": "sde_step.py::increment_diag_2d",
    "general": "sde_step.py::increment_general_2d",
}


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

        With ``use_kernels`` the reference fuses diagonal/additive/general
        increments with a TPU kernel that is still to port, so those raise;
        scalar noise and ODE mode stay on the plain path, as there.
        """
        if self.noise == "none" or g is None:
            return tree_scale(h, f)
        if use_kernels and self.noise in _UNPORTED_INCREMENT:
            raise ValueError(
                f"the fused increment for noise={self.noise!r} needs the TPU "
                f"kernel {_UNPORTED_INCREMENT[self.noise]}, which is not yet "
                "ported to repro_torch"
            )
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
