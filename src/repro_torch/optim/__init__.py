"""Optimizers of the port (the reference's update rules, functional)."""
from .optimizers import Optimizer, OptState, adamw, clip_by_global_norm, cosine_schedule, sgd

__all__ = ["adamw", "sgd", "cosine_schedule", "clip_by_global_norm",
           "Optimizer", "OptState"]
