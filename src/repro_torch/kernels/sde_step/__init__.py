"""Fused SDE-step kernels (Hopper CUDA): the Williamson 2N stage and its VJP,
the driver-weighted increment (diagonal, prediffused and general noise, the
stage too) and the Butcher axpy chain.

Layout as in ``repro.kernels.sde_step``: ``sde_step.py`` (kernel wrappers),
``ref.py`` (plain torch twins), ``ops.py`` (autograd + pytree layer).
"""
from .ops import (force_interpret, fused_axpy_chain, fused_increment, fused_ws_stage,
                  tree_axpy_chain, tree_increment, tree_ws_stage)

__all__ = ["force_interpret", "fused_increment", "fused_ws_stage", "fused_axpy_chain",
           "tree_increment", "tree_ws_stage", "tree_axpy_chain"]
