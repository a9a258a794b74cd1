"""Neural SDE models of the port: the Langevin SDE, its losses (moment MSE,
signature MMD) and the synthetic data of Tables 1, 2 and 7."""
from .data import gbm_paths, ou_paths, rough_vol_paths, stiff_gbm_matrix
from .fbm import fbm_increments, fbm_paths
from .losses import moment_mse, signature_mmd
from .models import LSDE, init_lsde, lsde_params_from_jax, lsde_readout, lsde_term
from .nets import MLP, Linear, init_linear, init_mlp, linear_apply, lipswish, mlp_apply

__all__ = ["LSDE", "init_lsde", "lsde_term", "lsde_readout",
           "lsde_params_from_jax", "MLP", "Linear", "init_linear", "init_mlp",
           "linear_apply", "mlp_apply", "lipswish", "moment_mse",
           "signature_mmd", "ou_paths", "stiff_gbm_matrix", "gbm_paths",
           "rough_vol_paths", "fbm_increments", "fbm_paths"]
