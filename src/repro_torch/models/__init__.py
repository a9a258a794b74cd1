"""LM architecture substrate (port of ``repro.models``): config-driven
``dense``/``moe``/``ssm``/``hybrid`` models (and the vision and audio
frontends) as ``nn.Module`` parameter trees and plain functions on tensors,
for inference and training; ``moe`` is the MoE layer; ``reversible``
integrates residual depth with EES(2,5) and the reversible adjoint."""
from . import moe, reversible
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
    "moe",
    "reversible",
    "serve_step",
]
