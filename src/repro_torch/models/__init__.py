"""LM architecture substrate (port of ``repro.models``): config-driven
``dense``/``ssm``/``hybrid`` models as ``nn.Module`` parameter trees and
plain functions on tensors, for inference and training; ``reversible``
integrates residual depth with EES(2,5) and the reversible adjoint."""
from . import reversible
from .common import ModelOptions, ShardingPolicy, constrain
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
    "constrain",
    "forward",
    "init_cache",
    "init_params",
    "lm_params_from_jax",
    "loss_fn",
    "make_serve_step",
    "make_train_step",
    "reversible",
    "serve_step",
]
