"""Fault tolerance of the port (`repro/ft`): the step watchdog and the
retry loop (`retry`, `watchdog`), the seeded chaos engine and traffic
traces (`chaos`), and drift measurement, detection and degraded
resolution for serving (`drift`).  Exports as the reference's
`repro/ft/__init__.py:29-46`.  The reference's `launch/ft.py` import shim
has no counterpart."""
from repro_torch.ft.chaos import (CHAOS_KINDS, CORRUPT_MODES, FaultEvent,
                                  FaultSchedule, TraceSegment, TrafficTrace,
                                  corrupt_checkpoint, excursion_trace)
from repro_torch.ft.drift import (DriftEstimator, ResolverChain,
                                  StagedRebuild, measure_p_x_one,
                                  weight_bit_sparsity)
from repro_torch.ft.retry import (RETRYABLE, Preemption, RetryPolicy,
                                  backoff_delays, run_with_retries)
from repro_torch.ft.watchdog import StepWatchdog, WatchdogReport

__all__ = [
    "CHAOS_KINDS", "CORRUPT_MODES", "FaultEvent", "FaultSchedule",
    "TraceSegment", "TrafficTrace", "corrupt_checkpoint", "excursion_trace",
    "DriftEstimator", "ResolverChain", "StagedRebuild", "measure_p_x_one",
    "weight_bit_sparsity",
    "RETRYABLE", "Preemption", "RetryPolicy", "backoff_delays",
    "run_with_retries",
    "StepWatchdog", "WatchdogReport",
]
