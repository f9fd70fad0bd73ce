"""Retry policy: capped, jittered exponential backoff around a resumable
session body (the port's copy of `repro/ft/retry.py`).

`run_with_retries` re-enters the body (a full train/serve session that
resumes from the latest checkpoint) on retryable failures -- the loop body
is idempotent by construction (stateless data stream + checkpointed step).
Backoff is exponential with a hard cap (`max_backoff_s`: an uncapped
2^restart ramp quickly turns a flaky dependency into an hours-long stall)
and deterministic seeded jitter (`jitter`, a +/- fraction of the delay):
when a rack-level preemption restarts many workers at once, identical
backoff schedules would stampede the checkpoint store / explorer service
in lockstep, so each process de-synchronizes by its own seed while any
GIVEN seed replays bit-identically for tests.
"""
from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable


class Preemption(RuntimeError):
    """Raised by the environment (or the chaos engine) to simulate node
    loss."""


RETRYABLE = (Preemption, OSError, TimeoutError)


@dataclasses.dataclass
class RetryPolicy:
    """Classification + backoff schedule for `run_with_retries`.

    ``seed=None`` derives the jitter stream from the process id -- the
    de-synchronized production default; pass an explicit seed for a
    bit-reproducible schedule (tests, the chaos bench).
    """
    max_restarts: int = 5
    backoff_s: float = 0.1
    max_backoff_s: float = 30.0
    jitter: float = 0.1          # +/- fraction of the capped delay
    seed: int | None = None

    def delay_s(self, restart: int) -> float:
        """Backoff before the ``restart``-th re-entry (1-based):
        min(base * 2^(restart-1), cap) * (1 + jitter * u), u ~ U[-1, 1)
        drawn deterministically from (seed, restart)."""
        base = min(self.backoff_s * 2.0 ** (restart - 1), self.max_backoff_s)
        if self.jitter <= 0.0:
            return base
        seed = os.getpid() if self.seed is None else self.seed
        u = random.Random(seed * 1_000_003 + restart).uniform(-1.0, 1.0)
        return base * (1.0 + self.jitter * u)


def backoff_delays(policy: RetryPolicy, n: int) -> list[float]:
    """The first ``n`` backoff delays of a policy (bound/spread tests)."""
    return [policy.delay_s(r) for r in range(1, n + 1)]


def run_with_retries(body: Callable[[], object],
                     policy: RetryPolicy | None = None,
                     on_restart: Callable[[int, BaseException], None]
                     | None = None):
    """Run `body` (a full session that resumes from the latest checkpoint)
    restarting on retryable failures.

    `policy=None` constructs a fresh RetryPolicy per call -- a dataclass
    default instance would be one MUTABLE object shared by every call site
    (a caller tweaking `policy.max_restarts` would change everyone else's).
    """
    if policy is None:
        policy = RetryPolicy()
    restarts = 0
    while True:
        try:
            return body()
        except RETRYABLE as e:          # noqa: PERF203
            restarts += 1
            if restarts > policy.max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            time.sleep(policy.delay_s(restarts))
