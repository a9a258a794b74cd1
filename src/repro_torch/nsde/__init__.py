"""Neural SDE models of the port: the Langevin SDE, its moment loss and the
OU target data of Table 1."""
from .data import ou_paths
from .losses import moment_mse
from .models import LSDE, init_lsde, lsde_params_from_jax, lsde_readout, lsde_term
from .nets import MLP, Linear, init_linear, init_mlp, lipswish

__all__ = ["LSDE", "init_lsde", "lsde_term", "lsde_readout",
           "lsde_params_from_jax", "MLP", "Linear", "init_linear", "init_mlp",
           "lipswish", "moment_mse", "ou_paths"]
