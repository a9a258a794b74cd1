"""Optimizers of the port (port of ``repro.optim.optimizers``): AdamW, SGD,
global-norm clipping and a cosine schedule.

The reference's update rule exactly, not a ``torch.optim`` class (their
defaults and rounding differ): float32 moments whatever the parameter
dtype, ``b2 = 0.95`` and ``max_grad_norm = 1.0`` by default, bias
corrections as float32 powers of the step, ``eps`` added outside
``sqrt(v / c2)``, weight decay added to the update before ``lr``.

Functional, as there: ``update(grads, state, params)`` returns new
parameters and a new :class:`OptState` and changes nothing in place.
``params`` and ``grads`` are matching pytrees of tensors (a list of an
``nn.Module``'s parameters, for instance).  The step counter is a device
tensor on the parameters' device, never read back by the host.

DTensor parameters and gradients (one layout each, as the LM's train steps
settle them) are updated shard by shard; the moments are DTensors placed
like their parameters, and the global norm is the norm of the whole
gradient: each leaf's sum of squares is reduced over its shards and the
leaves are summed in order on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from ..core.pytree import flatten_up_to, tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..spmd import is_dtensor, replicated

__all__ = ["adamw", "sgd", "cosine_schedule", "clip_by_global_norm",
           "Optimizer", "OptState"]


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (params, state, gnorm)


def _device_of(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _zeros(p):
    """A float32 moment of zeros for ``p``, placed like it when it is a
    DTensor."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(replicated(torch.sum(torch.square(g.to(torch.float32))))
                        for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def adamw(
    lr: Union[Callable, float],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
            mu=tree_map(_zeros, params),
            nu=tree_map(_zeros, params),
        )

    def update(grads, state: OptState, params):
        gnorm = torch.zeros((), dtype=torch.float32, device=state.step.device)
        if max_grad_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m2 = b1 * m + (1 - b1) * g32
            v2 = b2 * v + (1 - b2) * g32 * g32
            upd32 = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
            if weight_decay:
                upd32 = upd32 + weight_decay * p.to(torch.float32)
            p2 = (p.to(torch.float32) - lr_t * upd32).to(p.dtype)
            return p2, m2, v2

        g_leaves, treedef = tree_flatten(grads)
        out = [upd(*xs) for xs in zip(g_leaves,
                                      flatten_up_to(treedef, state.mu),
                                      flatten_up_to(treedef, state.nu),
                                      flatten_up_to(treedef, params))]
        pick = lambda i: tree_unflatten(treedef, [o[i] for o in out])  # noqa: E731
        return pick(0), OptState(step=step, mu=pick(1), nu=pick(2)), gnorm

    return Optimizer(init=init, update=update)


def sgd(lr: Union[Callable, float], momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        step = torch.zeros((), dtype=torch.int32, device=_device_of(params))
        if momentum:
            return OptState(step=step, nu=None, mu=tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params))
        return OptState(step=step, mu=None, nu=None)

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        zero = torch.zeros((), device=step.device)
        if momentum:
            mu2 = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                           state.mu, grads)
            params2 = tree_map(
                lambda p, m: (p.to(torch.float32) - lr_t * m).to(p.dtype),
                params, mu2)
            return params2, OptState(step=step, mu=mu2, nu=None), zero
        params2 = tree_map(
            lambda p, g: (p.to(torch.float32)
                          - lr_t * g.to(torch.float32)).to(p.dtype),
            params, grads)
        return params2, OptState(step=step, mu=None, nu=None), zero

    return Optimizer(init=init, update=update)
