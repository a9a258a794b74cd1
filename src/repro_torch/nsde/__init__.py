"""Neural SDE models of the port (the Langevin SDE so far)."""
from .models import LSDE, init_lsde, lsde_params_from_jax, lsde_readout, lsde_term
from .nets import MLP, Linear, init_linear, init_mlp, lipswish

__all__ = ["LSDE", "init_lsde", "lsde_term", "lsde_readout",
           "lsde_params_from_jax", "MLP", "Linear", "init_linear", "init_mlp",
           "lipswish"]
