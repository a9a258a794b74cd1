"""repro_torch.serving — the port's engines (port of ``repro.serving``).

  engine       — LM continuous-batching decode engine (fixed-slot serve_step)
  scheduler    — host-side SDE serving core: priority/FIFO queue, signature
                 grouping, slot plans, admission control, result
                 scatter/retirement, the retry ladder (device-free)
  executor     — device-side SDE serving core: tick-stack dispatch through
                 ``sdeint_ticks`` (no grad, on the executor's own stream),
                 warmup and the persistent kernel cache
  bucketing    — signature coalescing onto padded step-ladder buckets
                 (bitwise equal to exact dispatch)
  sde_engine   — the synchronous Monte-Carlo SDE sampling engine (façade
                 over the two layers)
  async_engine — asyncio continuous-batching serving plane: awaitable
                 submit/result with backpressure, cross-signature
                 interleaving, host-side double buffering, device-resident
                 results, supervised restarts
  faults       — deterministic fault injection (NaN trajectories, transient
                 executor crashes, delays) and FakeClock, for exercising the
                 guards, retries, deadlines and restarts
"""
from .async_engine import AsyncSDESampleEngine
from .bucketing import BucketingConfig, BucketKey, bucket_key, group_key, ladder_rung
from .engine import Engine, ServeConfig
from .executor import TickExecutor, enable_persistent_compile_cache
from .faults import FakeClock, FaultConfig, FaultyExecutor, InjectedCrash, inject_faults
from .scheduler import QueueFull, RetryPolicy, Scheduler, SlotPlan
from .sde_engine import SampleRequest, SampleResult, SDESampleConfig, SDESampleEngine

__all__ = [
    "Engine",
    "ServeConfig",
    "QueueFull",
    "Scheduler",
    "SlotPlan",
    "TickExecutor",
    "enable_persistent_compile_cache",
    "BucketingConfig",
    "BucketKey",
    "bucket_key",
    "group_key",
    "ladder_rung",
    "AsyncSDESampleEngine",
    "SDESampleEngine",
    "SDESampleConfig",
    "SampleRequest",
    "SampleResult",
    "RetryPolicy",
    "FaultConfig",
    "FaultyExecutor",
    "FakeClock",
    "InjectedCrash",
    "inject_faults",
]
