"""Small neural nets for neural-SDE vector fields (port of ``repro.nsde.nets``).

Weights keep the reference's layout — ``w`` is ``(d_in, d_out)`` and a layer
computes ``x @ w + b`` — so parameters move between the packages unchanged
and the two compute the same products.  Initialisation draws from the
port's threefry keys exactly as the reference draws from ``jax.random``.
The reference's functional forms, :func:`linear_apply` and
:func:`mlp_apply`, take either the modules or the reference's parameter
dicts (``{"w": ..., "b": ...}`` per layer).
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence

import torch
from torch import nn

from ..core import prng

__all__ = ["lipswish", "Linear", "MLP", "init_linear", "init_mlp",
           "linear_apply", "mlp_apply"]


def lipswish(x):
    """LipSwish, ``0.909 * silu(x)``: keeps the vector fields Lipschitz."""
    return 0.909 * torch.nn.functional.silu(x)


def linear_apply(p, x):
    """``x @ w + b`` for a :class:`Linear` or a ``{"w", "b"}`` dict."""
    if isinstance(p, Mapping):
        return x @ p["w"] + p["b"]
    return x @ p.w + p.b


def mlp_apply(layers, x, final_activation: Optional[Callable] = None):
    """The reference's ``mlp_apply``: each layer of ``layers`` (Linear
    modules or ``{"w", "b"}`` dicts) with LipSwish between them, then
    ``final_activation`` if given."""
    last = len(layers) - 1
    for i, p in enumerate(layers):
        x = linear_apply(p, x)
        if i < last:
            x = lipswish(x)
    if final_activation is not None:
        x = final_activation(x)
    return x


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` of shape ``(d_in, d_out)``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x):
        return linear_apply(self, x)


class MLP(nn.Module):
    """Linear layers with LipSwish between them (none after the last), then
    ``final_activation`` if given."""

    def __init__(self, layers: Sequence[Linear],
                 final_activation: Optional[Callable] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_activation = final_activation

    def forward(self, x):
        return mlp_apply(self.layers, x, self.final_activation)


def init_linear(key, d_in: int, d_out: int, dtype=torch.float32) -> Linear:
    """The reference's ``init_linear``: ``w = normal(split(key)[0]) / sqrt(d_in)``
    drawn in float32 (the reference's default draw dtype without x64),
    ``b = 0``."""
    k1 = prng.split(key)[0]
    w = prng.normal(k1, (d_in, d_out), torch.float32) / math.sqrt(d_in)
    return Linear(w.to(dtype), torch.zeros(d_out, dtype=dtype, device=key.device))


def init_mlp(key, sizes: Sequence[int], dtype=torch.float32) -> MLP:
    keys = prng.split(key, len(sizes) - 1)
    return MLP([init_linear(keys[i], a, b, dtype)
                for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))])
