"""Training of the port: the neural-SDE train step, the LM's accumulating
train step, scanned (graphed) steps, the train loops, checkpoints and fleet
health (single device)."""
from .checkpoint import checkpoint_meta, latest_step, restore_checkpoint, save_checkpoint
from .fault_tolerance import HeartbeatMonitor, RecoveryPlan, StragglerTracker, recovery_plan
from .trainer import (ResilienceConfig, TrainLoopConfig, init_scan_counters,
                      make_accum_train_step, make_scanned_step, make_sde_train_step,
                      resilient_train_loop, train_loop)

__all__ = ["make_accum_train_step", "make_sde_train_step", "make_scanned_step", "init_scan_counters",
           "train_loop", "TrainLoopConfig", "resilient_train_loop",
           "ResilienceConfig", "save_checkpoint", "restore_checkpoint",
           "latest_step", "checkpoint_meta", "HeartbeatMonitor",
           "StragglerTracker", "RecoveryPlan", "recovery_plan"]
