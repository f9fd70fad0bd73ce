"""Fault tolerance of the port: the step watchdog and the retry loop that
`launch.train` runs under (ports of `repro/ft/{watchdog,retry}.py`).  The
chaos engine, drift adaptation and checkpoints are not ported yet
(ROADMAP.md §1)."""
from repro_torch.ft.retry import (RETRYABLE, Preemption, RetryPolicy,
                                  backoff_delays, run_with_retries)
from repro_torch.ft.watchdog import StepWatchdog, WatchdogReport

__all__ = ["RETRYABLE", "Preemption", "RetryPolicy", "backoff_delays",
           "run_with_retries", "StepWatchdog", "WatchdogReport"]
