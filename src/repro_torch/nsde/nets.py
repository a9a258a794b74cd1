"""Small neural nets for neural-SDE vector fields (port of ``repro.nsde.nets``).

Weights keep the reference's layout — ``w`` is ``(d_in, d_out)`` and a layer
computes ``x @ w + b`` — so parameters move between the packages unchanged
and the two compute the same products.  Initialisation draws from the
port's threefry keys exactly as the reference draws from ``jax.random``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..core import prng

__all__ = ["lipswish", "Linear", "MLP", "init_linear", "init_mlp"]


def lipswish(x):
    """LipSwish, ``0.909 * silu(x)``: keeps the vector fields Lipschitz."""
    return 0.909 * torch.nn.functional.silu(x)


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` of shape ``(d_in, d_out)``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x):
        return x @ self.w + self.b


class MLP(nn.Module):
    """Linear layers with LipSwish between them (none after the last)."""

    def __init__(self, layers: Sequence[Linear]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = lipswish(x)
        return x


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
