"""Neural SDE model zoo (port of ``repro.nsde.models``).

* :class:`LSDE` — the neural Langevin SDE: ``dz = g(z) dt + f(t) o dW``,
  ``z0 = affine(x)``, read out to data space: an MLP drift, a time-only MLP
  diffusion (declared diagonal noise, as in the reference) and linear
  encoder/readout;
* :func:`kuramoto_nsde_term` — the NSDE on ``T*T^N`` with MLP drift and
  diffusion over the periodic encoding ``(sin th, cos th, om)``, outputs in
  the Lie algebra ``R^{2N}`` (:class:`KuramotoNSDE` holds the two MLPs);
* :func:`sphere_nsde_term` — the latent SDE on ``S^{n-1} = SO(n)/SO(n-1)``
  with an MLP so(n)-valued drift and basis diffusion (:class:`SphereNSDE`
  holds the MLP and ``log_sigma``).

The ``init_*`` functions draw the reference's parameters from the port's
keys; the ``*_params_from_jax`` functions carry the reference's parameter
dicts (numpy or jax arrays) across.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..core import prng
from ..core.lie import Euclidean, ManifoldSDETerm, Product, SphereAction, Torus
from ..core.solvers import SDETerm
from ..device import resolve_device
from .nets import MLP, Linear, init_linear, init_mlp

__all__ = ["LSDE", "init_lsde", "lsde_term", "lsde_readout",
           "lsde_params_from_jax", "KuramotoNSDE", "init_kuramoto_nsde",
           "kuramoto_nsde_term", "kuramoto_params_from_jax", "SphereNSDE",
           "init_sphere_nsde", "sphere_nsde_term", "sphere_params_from_jax"]


class LSDE(nn.Module):
    """Encoder, drift MLP, diffusion MLP (of time) and readout."""

    def __init__(self, encoder: Linear, drift: MLP, diff: MLP, readout: Linear):
        super().__init__()
        self.encoder = encoder
        self.drift = drift
        self.diff = diff
        self.readout = readout


def _key(key, device) -> torch.Tensor:
    """A ``(2,)`` key, or an int seed's ``PRNGKey``, on ``device`` (a key
    tensor given without ``device`` stays where it is)."""
    if not isinstance(key, torch.Tensor):
        return prng.PRNGKey(key, device=device)
    return key if device is None else key.to(resolve_device(device))


def init_lsde(key, d_obs: int, d_z: int = 32, width: int = 32, *,
              dtype=torch.float32, device=None) -> LSDE:
    """The reference's ``init_lsde`` on the port's keys: ``key`` is a
    ``(2,)`` key or an int seed (``PRNGKey(seed)``)."""
    ks = prng.split(_key(key, device), 4)
    return LSDE(
        encoder=init_linear(ks[0], d_obs, d_z, dtype),
        drift=init_mlp(ks[1], [d_z, width, width, d_z], dtype),
        diff=init_mlp(ks[2], [1, width, d_z], dtype),
        readout=init_linear(ks[3], d_z, d_obs, dtype),
    )


def lsde_term() -> SDETerm:
    """Drift ``g(z)`` and diffusion ``softplus(f(t)) * 0.5 + 0.05``.

    The diffusion depends on ``t`` only.  A time shared by every path (a
    float, or a one-element tensor) is evaluated once on a ``(1, ..., 1)``
    input and broadcast over the (batched) state; per-path times (an
    adaptive solve's, shaped ``(*batch, 1)``) are evaluated per path — the
    reference evaluates the same MLP on every path's own ``t``.
    """

    def drift(t, z, p):
        return p.drift(z)

    def diffusion(t, z, p):
        shape = (1,) * z.dim()
        if isinstance(t, torch.Tensor) and t.numel() > 1:
            tvec = t.to(dtype=z.dtype, device=z.device).expand(
                tuple(z.shape[:-1]) + (1,))
            g = p.diff(tvec)
            return torch.logaddexp(g, torch.zeros_like(g)) * 0.5 + 0.05
        if isinstance(t, torch.Tensor):
            tvec = t.to(dtype=z.dtype, device=z.device).reshape(shape)
        else:  # a host float (t0): filled on the device, no host copy
            tvec = torch.full(shape, float(t), dtype=z.dtype, device=z.device)
        g = p.diff(tvec)
        return (torch.logaddexp(g, torch.zeros_like(g)) * 0.5 + 0.05).expand(z.shape)

    return SDETerm(drift=drift, diffusion=diffusion, noise="diagonal")


def lsde_readout(p: LSDE, z):
    return p.readout(z)


def _tensor_from(x, dtype, device) -> torch.Tensor:
    x = torch.as_tensor(np.array(x), device=device)
    return x if dtype is None else x.to(dtype)


def _linear_from(d: Mapping[str, Any], dtype, device) -> Linear:
    return Linear(_tensor_from(d["w"], dtype, device),
                  _tensor_from(d["b"], dtype, device))


def _mlp_from(layers, dtype, device) -> MLP:
    return MLP([_linear_from(p, dtype, device) for p in layers])


def lsde_params_from_jax(params: Mapping[str, Any], *, dtype=None,
                         device=None) -> LSDE:
    """The reference's LSDE params (a dict of ``{"w", "b"}`` layers and
    layer lists, numpy or jax arrays, ``w`` as ``(d_in, d_out)``) as an
    :class:`LSDE` on ``device``; ``dtype`` (default: the arrays') converts."""
    device = resolve_device(device)
    return LSDE(
        encoder=_linear_from(params["encoder"], dtype, device),
        drift=_mlp_from(params["drift"], dtype, device),
        diff=_mlp_from(params["diff"], dtype, device),
        readout=_linear_from(params["readout"], dtype, device),
    )


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's ``softplus``
    returns ``x`` itself past its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Kuramoto NSDE on T*T^N (Section 4).
# ---------------------------------------------------------------------------

class KuramotoNSDE(nn.Module):
    """Drift MLP ``3N -> width -> width -> 2N`` and diffusion MLP
    ``3N -> width -> N``."""

    def __init__(self, drift: MLP, diff: MLP):
        super().__init__()
        self.drift = drift
        self.diff = diff


def init_kuramoto_nsde(key, N: int, width: int = 128, *, dtype=torch.float32,
                       device=None) -> KuramotoNSDE:
    """The reference's ``init_kuramoto_nsde`` on the port's keys."""
    ks = prng.split(_key(key, device), 2)
    return KuramotoNSDE(drift=init_mlp(ks[0], [3 * N, width, width, 2 * N], dtype),
                        diff=init_mlp(ks[1], [3 * N, width, N], dtype))


def kuramoto_nsde_term() -> ManifoldSDETerm:
    """The Kuramoto NSDE on ``Torus x Euclidean``: state ``(theta, omega)``,
    additive-in-form noise on ``omega`` only (the diffusion still depends on
    the state, so the noise is declared diagonal)."""
    group = Product([Torus(), Euclidean()])

    def features(y):
        th, om = y
        return torch.cat([torch.sin(th), torch.cos(th), om], dim=-1)

    def drift(t, y, p):
        out = p.drift(features(y))
        N = out.shape[-1] // 2
        return (out[..., :N], out[..., N:])

    def diffusion(t, y, p):
        th, _ = y
        sig = 0.1 * _softplus(p.diff(features(y)))
        return (torch.zeros_like(th), sig)

    return ManifoldSDETerm(group=group, drift=drift, diffusion=diffusion,
                           noise="diagonal")


def kuramoto_params_from_jax(params: Mapping[str, Any], *, dtype=None,
                             device=None) -> KuramotoNSDE:
    """The reference's Kuramoto params (``{"drift": [...], "diff": [...]}``
    of ``{"w", "b"}`` layers) as a :class:`KuramotoNSDE` on ``device``."""
    device = resolve_device(device)
    return KuramotoNSDE(drift=_mlp_from(params["drift"], dtype, device),
                        diff=_mlp_from(params["diff"], dtype, device))


# ---------------------------------------------------------------------------
# Latent SDE on the sphere S^{n-1} (Section 4, Zeng et al. setup).
# ---------------------------------------------------------------------------

def _skew_basis_map(n: int):
    """``(to_skew, m)``: ``to_skew`` maps ``(..., m)`` coordinates on the
    upper-triangle basis of so(n) to ``(..., n, n)`` skew matrices,
    ``m = n (n - 1) / 2``."""
    rows, cols = torch.triu_indices(n, n, 1)
    on_device = {}  # the indices, copied once to each device they meet

    def to_skew(v):
        if v.device not in on_device:
            on_device[v.device] = (rows.to(v.device), cols.to(v.device))
        iu = on_device[v.device]
        S = v.new_zeros(tuple(v.shape[:-1]) + (n, n))
        S[..., iu[0], iu[1]] = v
        return S - S.transpose(-1, -2)

    return to_skew, n * (n - 1) // 2


class SphereNSDE(nn.Module):
    """Drift MLP ``n + 1 + d_ctx -> width -> width -> n(n-1)/2`` and the
    scalar ``log_sigma`` of the basis diffusion."""

    def __init__(self, drift: MLP, log_sigma: torch.Tensor):
        super().__init__()
        self.drift = drift
        self.log_sigma = nn.Parameter(log_sigma)


def init_sphere_nsde(key, n: int, width: int = 64, d_ctx: int = 0, *,
                     dtype=torch.float32, device=None) -> SphereNSDE:
    """The reference's ``init_sphere_nsde`` on the port's keys
    (``log_sigma = 0``)."""
    key = _key(key, device)
    _, m = _skew_basis_map(n)
    ks = prng.split(key, 2)
    return SphereNSDE(drift=init_mlp(ks[0], [n + 1 + d_ctx, width, width, m], dtype),
                      log_sigma=torch.zeros((), dtype=dtype, device=key.device))


def _time_column(t, y) -> torch.Tensor:
    """``t`` as a ``(*y.shape[:-1], 1)`` column in ``y``'s dtype: a shared
    time (a float or a one-element tensor) is broadcast, per-path times
    (``(*batch, 1)``) are taken as they are."""
    shape = tuple(y.shape[:-1]) + (1,)
    if isinstance(t, torch.Tensor):
        t = t.to(dtype=y.dtype, device=y.device)
        return (t if t.numel() > 1 else t.reshape(())).expand(shape)
    return torch.full(shape, float(t), dtype=y.dtype, device=y.device)


def sphere_nsde_term(n: int, ctx=None) -> ManifoldSDETerm:
    """The latent SDE on ``S^{n-1}``: drift ``to_skew(0.5 tanh(MLP(y, t[,
    ctx])))``, diffusion ``0.1 exp(log_sigma)`` on each of the ``n(n-1)/2``
    so(n) basis directions (general noise: ``noise_shape=(m,)``)."""
    group = SphereAction(n)
    to_skew, _ = _skew_basis_map(n)

    def drift(t, y, p):
        feats = torch.cat([y, _time_column(t, y)]
                          + ([ctx] if ctx is not None else []), dim=-1)
        return to_skew(0.5 * torch.tanh(p.drift(feats)))

    def diffusion(t, y, p):
        return torch.exp(p.log_sigma) * 0.1

    return ManifoldSDETerm(
        group=group,
        drift=drift,
        diffusion=diffusion,
        noise="general",
        noise_apply=lambda sig, dw: to_skew(sig * dw),
    )


def sphere_params_from_jax(params: Mapping[str, Any], *, dtype=None,
                           device=None) -> SphereNSDE:
    """The reference's sphere params (``{"drift": [...], "log_sigma": ()}``)
    as a :class:`SphereNSDE` on ``device``."""
    device = resolve_device(device)
    return SphereNSDE(drift=_mlp_from(params["drift"], dtype, device),
                      log_sigma=_tensor_from(params["log_sigma"], dtype, device))
