"""LM architecture substrate, inference path (port of ``repro.models``):
config-driven ``dense``/``ssm``/``hybrid`` models as ``nn.Module``
parameter trees and plain functions on tensors."""
from .common import ModelOptions, ShardingPolicy
from .transformer import (
    LMParams,
    forward,
    init_cache,
    init_params,
    lm_params_from_jax,
    loss_fn,
    make_serve_step,
    make_train_step,
    serve_step,
)

__all__ = [
    "LMParams",
    "ModelOptions",
    "ShardingPolicy",
    "forward",
    "init_cache",
    "init_params",
    "lm_params_from_jax",
    "loss_fn",
    "make_serve_step",
    "make_train_step",
    "serve_step",
]
