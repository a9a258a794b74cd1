"""The neural Langevin SDE (port of ``repro.nsde.models``, Langevin part).

``dz = g(z) dt + f(t) o dW``, ``z0 = affine(x)``, read out to data space:
an MLP drift, a time-only MLP diffusion (declared diagonal noise, as in the
reference) and linear encoder/readout.  :class:`LSDE` holds the four nets;
:func:`lsde_params_from_jax` carries the reference's parameters across.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..core import prng
from ..core.solvers import SDETerm
from ..device import resolve_device
from .nets import MLP, Linear, init_linear, init_mlp

__all__ = ["LSDE", "init_lsde", "lsde_term", "lsde_readout",
           "lsde_params_from_jax"]


class LSDE(nn.Module):
    """Encoder, drift MLP, diffusion MLP (of time) and readout."""

    def __init__(self, encoder: Linear, drift: MLP, diff: MLP, readout: Linear):
        super().__init__()
        self.encoder = encoder
        self.drift = drift
        self.diff = diff
        self.readout = readout


def init_lsde(key, d_obs: int, d_z: int = 32, width: int = 32, *,
              dtype=torch.float32, device=None) -> LSDE:
    """The reference's ``init_lsde`` on the port's keys: ``key`` is a
    ``(2,)`` key or an int seed (``PRNGKey(seed)``)."""
    if not isinstance(key, torch.Tensor):
        key = prng.PRNGKey(key, device=device)
    else:
        key = key.to(resolve_device(device))
    ks = prng.split(key, 4)
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


def _linear_from(d: Mapping[str, Any], dtype, device) -> Linear:
    def t(x):
        x = torch.as_tensor(np.array(x), device=device)
        return x if dtype is None else x.to(dtype)

    return Linear(t(d["w"]), t(d["b"]))


def lsde_params_from_jax(params: Mapping[str, Any], *, dtype=None,
                         device=None) -> LSDE:
    """The reference's LSDE params (a dict of ``{"w", "b"}`` layers and
    layer lists, numpy or jax arrays, ``w`` as ``(d_in, d_out)``) as an
    :class:`LSDE` on ``device``; ``dtype`` (default: the arrays') converts."""
    device = resolve_device(device)
    return LSDE(
        encoder=_linear_from(params["encoder"], dtype, device),
        drift=MLP([_linear_from(p, dtype, device) for p in params["drift"]]),
        diff=MLP([_linear_from(p, dtype, device) for p in params["diff"]]),
        readout=_linear_from(params["readout"], dtype, device),
    )
