"""Bounded retry with exponential backoff, jitter and deadlines (copy of
the JAX package's ``utils/retry.py``).

Every retry is bounded three ways: an attempt count, a cap on each
backoff, and a wall-clock deadline; the backoff is jittered so clients
whose server just restarted do not reconnect in lockstep.
``RetryPolicy`` is data: callers with their own loop (the registry
client, idempotency-aware) read it, and ``retry_call`` wraps a plain
call. The fleet's quarantine ladder (``fleet/health.py``) is a
``RetryPolicy`` too.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry shape: up to ``attempts`` tries in total, sleeping
    ``base_s * multiplier**(attempt-1)`` (capped at ``max_s``, jittered
    ±``jitter`` fraction) between them, never past ``deadline_s`` of
    wall clock from the first attempt. ``attempts=1`` means no retry."""

    attempts: int = 4
    base_s: float = 0.02
    multiplier: float = 2.0
    max_s: float = 1.0
    jitter: float = 0.5
    deadline_s: float = float("inf")

    def __post_init__(self) -> None:
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def backoff_s(self, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
        """Sleep before retry number ``attempt`` (1-based: the sleep
        between the first failure and the second try is attempt 1)."""
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        delay = min(self.base_s * self.multiplier ** (attempt - 1),
                    self.max_s)
        if self.jitter:
            u = (rng.random() if rng is not None else random.random())
            delay *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(delay, 0.0)

    def deadline_from(self, now: float) -> float:
        return now + self.deadline_s

    def give_up(self, attempt: int, now: float, deadline: float,
                next_delay_s: float = 0.0) -> bool:
        """True when retry number ``attempt`` must NOT happen: the
        attempt bound is spent, or sleeping ``next_delay_s`` would land
        past the deadline (waking up only to time out is worse than
        failing now — the caller gets its error while there is still
        deadline budget to act on it)."""
        return attempt >= self.attempts or now + next_delay_s >= deadline


def retry_call(
    fn: Callable,
    policy: RetryPolicy,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    rng: Optional[random.Random] = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` under ``policy``: retry on ``retry_on`` exceptions
    with jittered exponential backoff until the attempt bound or the
    deadline is spent, then re-raise the LAST failure. ``on_retry`` is
    invoked once per retry (after the failure, before the sleep) — the
    metrics hook behind ``tpu_sched_rpc_retries_total``."""
    deadline = policy.deadline_from(clock())
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            delay = policy.backoff_s(attempt, rng=rng)
            if policy.give_up(attempt, clock(), deadline, delay):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)
