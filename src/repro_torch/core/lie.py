"""Lie groups, homogeneous spaces, and manifold-valued SDE terms.

Port of ``repro.core.lie``.  A homogeneous space is a :class:`Group` object
supplying the composed map ``exp_action(v, y) = Lambda(exp(v), y)`` for an
algebra element ``v`` and a point ``y``.  Vector fields are state-dependent
generators ``xi: (t, y, args) -> g`` (Section C.1).  On a flat space
(:class:`Euclidean`) ``exp_action(v, y) = y + v`` and every geometric scheme
collapses to its Euclidean counterpart, bit for bit.

Points and algebra elements are pytrees; :class:`Product` combines groups
componentwise (``T*T^N = Torus x Euclidean`` for the Kuramoto model).  Every
group takes any number of leading path axes: the port writes out the path
batch the reference vmaps over.

The matrix exponential of :class:`SOn` and :class:`SphereAction` is
:func:`expm`: the reference's ``jax.scipy.linalg.expm`` (scaling and
squaring with a diagonal Pade approximant), batched.
``torch.linalg.matrix_exp`` truncates a Taylor series instead: its results
are not exactly orthogonal for a skew argument, and over a few hundred
exponentials a sphere path drifts off the sphere by ~5e-12 in float64,
where the Pade form, orthogonal up to rounding, stays below 1e-12 as the
reference's does.  The two exponentials agree to rounding, not bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import torch

from .pytree import tree_leaves, tree_map, tree_scale

__all__ = [
    "Group",
    "Euclidean",
    "Torus",
    "SO3",
    "SOn",
    "SphereAction",
    "Product",
    "ManifoldSDETerm",
    "skew_from_vec",
    "vec_from_skew",
    "rodrigues",
    "expm",
]

TWO_PI = 2.0 * math.pi


class Group:
    """Interface: ``exp_action(v, y)`` and a manifold-membership check."""

    name = "group"

    def exp_action(self, v, y):
        raise NotImplementedError

    def project(self, y):
        """Optional numerical re-projection onto the manifold (default: identity)."""
        return y

    def distance_from_manifold(self, y):
        """Scalar diagnostic: 0 iff y is on the manifold."""
        leaf = tree_leaves(y)[0]
        return torch.zeros((), dtype=leaf.dtype, device=leaf.device)


class Euclidean(Group):
    """Translation group acting on R^d — the flat case."""

    name = "euclidean"

    def exp_action(self, v, y):
        return tree_map(lambda yi, vi: yi + vi, y, v)


class Torus(Group):
    """T^d with angles stored in [-pi, pi).  exp_action wraps the translation.

    ``round`` has zero derivative, so gradients flow through the wrap as the
    identity — the correct chart derivative.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does.
    """

    name = "torus"

    @staticmethod
    def wrap(x):
        return x - TWO_PI * torch.round(x / TWO_PI)

    def exp_action(self, v, y):
        return tree_map(lambda yi, vi: self.wrap(yi + vi), y, v)

    def project(self, y):
        return tree_map(self.wrap, y)

    def distance_from_manifold(self, y):
        return sum(torch.clamp_min(x.abs() - math.pi, 0.0).sum()
                   for x in tree_leaves(y))


def skew_from_vec(w):
    """(..., 3) axis-angle vector -> (..., 3, 3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vec_from_skew(S):
    return torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], dim=-1)


def rodrigues(w):
    """exp of so(3) via Rodrigues, numerically safe at theta -> 0.

    R = I + sinc(theta) K + (1 - cos theta)/theta^2 K^2 with K = skew(w).
    Both branches stay finite at ``w = 0`` (``theta`` carries a 1e-30
    floor), so the gradient there is finite too.
    """
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    small = theta2 < 1e-8
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + 1e-30))
    K = skew_from_vec(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + s[..., None, None] * K + c[..., None, None] * K2


# Pade coefficients b_0..b_m of the top degrees jax.scipy.linalg.expm uses.
_PADE = {
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
    13: (64764752532480000., 32382376266240000., 7771770303897600.,
         1187353796428800., 129060195264000., 10559470521600., 670442572800.,
         33522128640., 1323241920., 40840800., 960960., 16380., 182., 1.),
}
# (largest 1-norm the degree takes without squaring, degree) by dtype.
_PADE_PLAN = {torch.float64: (5.371920351148152, 13),
              torch.float32: (3.925724783138660, 7)}
MAX_SQUARINGS = 16


def _pade_uv(A, powers, degree):
    """``(U, V)``: the odd and even parts of the degree-``degree`` Pade
    numerator, ``p(A) = U + V`` and ``q(A) = V - U``, summed in the
    reference's order (highest power first)."""
    b = _PADE[degree]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2, A4, A6 = powers
    if degree == 13:
        U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
                 + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
        V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
             + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
        return U, V
    U = A @ (b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye
    return U, V


def expm(A: torch.Tensor) -> torch.Tensor:
    """Matrix exponential of ``(..., n, n)`` float32 or float64 matrices by
    ``jax.scipy.linalg.expm``'s scaling and squaring, batched: each matrix
    is scaled by its own ``2**s`` (``s`` from its 1-norm, as there), its
    degree-13 (float64) or degree-7 (float32) diagonal Pade approximant is
    solved, and it is squared ``s`` times (NaN past 16 squarings, as
    there).  The reference drops to a lower degree where the 1-norm allows;
    that saves work, not accuracy, and here every matrix takes the top
    degree, so a batch needs no per-matrix branch.  Nothing here reads the
    device from the host."""
    if A.dtype not in _PADE_PLAN:
        raise ValueError(f"expm supports float32 and float64, got {A.dtype}")
    maxnorm, degree = _PADE_PLAN[A.dtype]
    with torch.no_grad():
        norm = A.abs().sum(dim=-2).amax(dim=-1)          # the 1-norm
        n_sq = torch.clamp_min(torch.floor(torch.log2(norm / maxnorm)), 0.0)
        # square[..., i]: does the matrix take squaring i?  (one launch for
        # all sixteen masks)
        square = (torch.arange(MAX_SQUARINGS + 1, dtype=A.dtype, device=A.device)
                  < n_sq[..., None])[..., None, None]
    A = A / (2.0 ** n_sq)[..., None, None]
    A2 = A @ A
    A4 = A2 @ A2
    U, V = _pade_uv(A, (A2, A4, A4 @ A2), degree)
    # solve_ex: no host read of the factorization's status (a Pade
    # denominator at these norms is far from singular).
    R = torch.linalg.solve_ex(V - U, U + V)[0]
    for i in range(MAX_SQUARINGS):
        R = torch.where(square[..., i, :, :], R @ R, R)
    return torch.where(square[..., MAX_SQUARINGS, :, :],
                       torch.full_like(R, float("nan")), R)


def _orthogonality_gap(y, n: int):
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    return torch.max(torch.abs(y.transpose(-1, -2) @ y - eye))


class SO3(Group):
    """SO(3) acting on itself by left translation; algebra = axis-angle vectors."""

    name = "so3"

    def exp_action(self, v, y):
        return rodrigues(v) @ y

    def project(self, y):
        # Polar projection (symmetric orthogonalisation): U V^T is the same
        # whatever signs the SVD picks for its singular vectors.
        u, _, vt = torch.linalg.svd(y)
        return u @ vt

    def distance_from_manifold(self, y):
        return _orthogonality_gap(y, 3)


class SOn(Group):
    """SO(n) by left translation; algebra = (..., n, n) skew matrices."""

    name = "son"

    def __init__(self, n: int):
        self.n = n

    def exp_action(self, v, y):
        return expm(v) @ y

    def distance_from_manifold(self, y):
        return _orthogonality_gap(y, self.n)


class SphereAction(Group):
    """S^{n-1} = SO(n)/SO(n-1): points are unit vectors (..., n), the algebra
    is so(n), and the action is ``y -> expm(V) y``.

    The generic matrix exponential makes *any* so(n) generator valid
    (isotropy components act trivially: Example C.1).
    """

    name = "sphere"

    def __init__(self, n: int):
        self.n = n

    def exp_action(self, v, y):
        return torch.einsum("...ij,...j->...i", expm(v), y)

    def project(self, y):
        return y / torch.linalg.norm(y, dim=-1, keepdim=True)

    def distance_from_manifold(self, y):
        return torch.max(torch.abs(torch.sum(y * y, dim=-1) - 1.0))


class Product(Group):
    """Direct product acting componentwise on tuples of points/algebra elems."""

    name = "product"

    def __init__(self, groups: Sequence[Group]):
        self.groups = tuple(groups)

    def exp_action(self, v, y):
        return tuple(g.exp_action(vi, yi) for g, vi, yi in zip(self.groups, v, y))

    def project(self, y):
        return tuple(g.project(yi) for g, yi in zip(self.groups, y))

    def distance_from_manifold(self, y):
        return sum(g.distance_from_manifold(yi) for g, yi in zip(self.groups, y))


# ---------------------------------------------------------------------------
# Manifold SDE term.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ManifoldSDETerm:
    """SDE on a homogeneous space: dy = (xi_f(y) dt + xi_g(y) . dW)_M.

    ``drift``/``diffusion`` return Lie-algebra elements (pytrees).  With
    ``noise='diagonal'`` the diffusion output is multiplied elementwise by a
    same-shaped ``dW``; ``noise_apply`` overrides that pairing (e.g. mapping an
    m-vector of noises onto a basis of so(n)).
    """

    group: Group
    drift: Callable[..., Any]
    diffusion: Optional[Callable[..., Any]] = None
    noise: str = "diagonal"
    noise_apply: Optional[Callable[[Any, Any], Any]] = None

    def algebra_increment(self, t, y, args, h, dW):
        out = tree_scale(h, self.drift(t, y, args))
        if self.noise == "none" or self.diffusion is None:
            return out
        g = self.diffusion(t, y, args)
        if self.noise_apply is not None:
            return tree_map(lambda o, n: o + n, out, self.noise_apply(g, dW))
        return tree_map(lambda o, gi, wi: o + gi * wi, out, g, dW)
