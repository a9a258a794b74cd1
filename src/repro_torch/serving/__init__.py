"""repro_torch.serving — the port's engines.

  engine     — LM continuous-batching decode engine (fixed-slot serve_step)
  scheduler  — host-side queue, admission, priorities, slot plans, retries
  bucketing  — signature coalescing onto padded step-ladder buckets
  executor   — device-side tick-stack dispatch through ``sdeint_ticks``
  sde_engine — the synchronous engine (façade over the two layers)
"""
from .bucketing import BucketingConfig, BucketKey, bucket_key, group_key, ladder_rung
from .engine import Engine, ServeConfig
from .executor import TickExecutor
from .scheduler import QueueFull, RetryPolicy, Scheduler, SlotPlan
from .sde_engine import SampleRequest, SampleResult, SDESampleConfig, SDESampleEngine

__all__ = [
    "Engine",
    "ServeConfig",
    "QueueFull",
    "Scheduler",
    "SlotPlan",
    "TickExecutor",
    "BucketingConfig",
    "BucketKey",
    "bucket_key",
    "group_key",
    "ladder_rung",
    "SDESampleEngine",
    "SDESampleConfig",
    "SampleRequest",
    "SampleResult",
    "RetryPolicy",
]
