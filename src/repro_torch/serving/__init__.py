"""repro_torch.serving — the Monte-Carlo SDE sampling engine of the port.

  scheduler  — host-side queue, admission, priorities, slot plans, retries
  bucketing  — signature coalescing onto padded step-ladder buckets
  executor   — device-side tick-stack dispatch through ``sdeint_ticks``
  sde_engine — the synchronous engine (façade over the two layers)
"""
from .bucketing import BucketingConfig, BucketKey, bucket_key, group_key, ladder_rung
from .executor import TickExecutor
from .scheduler import QueueFull, RetryPolicy, Scheduler, SlotPlan
from .sde_engine import SampleRequest, SampleResult, SDESampleConfig, SDESampleEngine

__all__ = [
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
