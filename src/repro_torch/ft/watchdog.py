"""Heartbeat/step-time watchdog: tracks a rolling step-time distribution;
a step exceeding p50 * straggler_factor is flagged (at scale: triggers
hot-spare swap or collective reconfiguration; here: logged + counted, and
a standing policy object decides restart vs skip).  The port's copy of
`repro/ft/watchdog.py`."""
from __future__ import annotations

import dataclasses
import time
from collections import deque


@dataclasses.dataclass
class WatchdogReport:
    step: int
    duration: float
    p50: float
    is_straggler: bool


class StepWatchdog:
    def __init__(self, straggler_factor: float = 3.0, window: int = 50,
                 warmup_steps: int = 3):
        self.factor = straggler_factor
        self.times: deque = deque(maxlen=window)
        self.warmup = warmup_steps
        self.straggler_count = 0
        self.steps_observed = 0
        self._t0 = None
        self._step = -1

    def start(self, step: int):
        self._step = step
        self._t0 = time.monotonic()

    def stop(self) -> WatchdogReport:
        dur = time.monotonic() - self._t0
        hist = sorted(self.times)
        if hist:
            # true median: average the two middle samples on even windows
            # (hist[len//2] alone is the UPPER middle — biased high)
            mid = len(hist) // 2
            p50 = (hist[mid] if len(hist) % 2
                   else 0.5 * (hist[mid - 1] + hist[mid]))
        else:
            p50 = dur
        # warmup counts every step SEEN, not just the non-straggler samples
        # kept in `times` — otherwise a noisy warmup keeps extending itself
        warm = self.steps_observed >= self.warmup
        self.steps_observed += 1
        straggler = warm and dur > self.factor * p50
        if straggler:
            self.straggler_count += 1
        else:
            self.times.append(dur)   # keep the baseline uncontaminated
        return WatchdogReport(self._step, dur, p50, straggler)
