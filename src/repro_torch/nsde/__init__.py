"""Neural SDE models of the port: the Langevin SDE, the Kuramoto NSDE on
T*T^N and the latent SDE on the sphere, their losses (moment MSE, wrapped
energy score, signature MMD) and the synthetic data of Tables 1, 2, 3 and
7."""
from .data import gbm_paths, kuramoto_paths, ou_paths, rough_vol_paths, stiff_gbm_matrix
from .fbm import fbm_increments, fbm_paths
from .losses import moment_mse, signature_mmd, wrapped_energy_score
from .models import (LSDE, KuramotoNSDE, SphereNSDE, init_kuramoto_nsde, init_lsde,
                     init_sphere_nsde, kuramoto_nsde_term, kuramoto_params_from_jax,
                     lsde_params_from_jax, lsde_readout, lsde_term, sphere_nsde_term,
                     sphere_params_from_jax)
from .nets import MLP, Linear, init_linear, init_mlp, linear_apply, lipswish, mlp_apply

__all__ = ["LSDE", "init_lsde", "lsde_term", "lsde_readout",
           "lsde_params_from_jax", "KuramotoNSDE", "init_kuramoto_nsde",
           "kuramoto_nsde_term", "kuramoto_params_from_jax", "SphereNSDE",
           "init_sphere_nsde", "sphere_nsde_term", "sphere_params_from_jax",
           "MLP", "Linear", "init_linear", "init_mlp", "linear_apply",
           "mlp_apply", "lipswish", "moment_mse", "wrapped_energy_score", "signature_mmd",
           "ou_paths", "stiff_gbm_matrix", "gbm_paths", "kuramoto_paths",
           "rough_vol_paths", "fbm_increments", "fbm_paths"]
