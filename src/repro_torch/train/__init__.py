"""Training of the port: the neural-SDE train step (single device)."""
from .trainer import make_sde_train_step

__all__ = ["make_sde_train_step"]
