"""Fused SDE-step kernel (Hopper CUDA) for the Williamson 2N stage.

Layout as in ``repro.kernels.sde_step``: ``sde_step.py`` (kernel wrapper),
``ref.py`` (plain torch twin), ``ops.py`` (autograd + pytree layer).
"""
from .ops import fused_ws_stage, tree_ws_stage

__all__ = ["fused_ws_stage", "tree_ws_stage"]
