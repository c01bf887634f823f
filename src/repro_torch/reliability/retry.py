"""Capped exponential backoff with deterministic jitter (DESIGN.md §13).

A copy of ``repro.reliability.retry`` (host-only Python, no tensors).

The delay for attempt ``k`` is::

    min(base_delay_s * multiplier**k, max_delay_s) * (1 + jitter_frac * u)

where ``u in [-1, 1]`` is drawn from a counter-keyed stream over
``(seed, k)`` — the same policy instance always produces the same delay
sequence, so retry timing (like fault schedules) is bit-reproducible and
unit-testable without mocking randomness.  Jitter still does its job in a
fleet: give each replica a distinct ``seed`` and their retries decorrelate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["RetryPolicy"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Frozen retry schedule; ``max_attempts=1`` means no retries.

    ``retryable`` is the exception-class tuple worth retrying; anything
    else propagates immediately (a programming error is not a transient).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 1.0
    multiplier: float = 2.0
    jitter_frac: float = 0.1
    seed: int = 0
    retryable: tuple = (Exception,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError("need 0 <= base_delay_s <= max_delay_s")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError("jitter_frac must be in [0, 1)")

    def delay_s(self, attempt: int) -> float:
        """Backoff before retrying after failed attempt ``attempt`` (0-based).
        Deterministic in (policy fields, attempt)."""
        d = min(self.base_delay_s * self.multiplier ** attempt,
                self.max_delay_s)
        if self.jitter_frac:
            u = 2.0 * float(
                np.random.default_rng([self.seed, attempt]).random()) - 1.0
            d *= 1.0 + self.jitter_frac * u
        return d

    def call(self, fn: Callable, *,
             on_retry: Optional[Callable] = None,
             sleep: Callable = time.sleep):
        """Run ``fn()`` under this policy; returns its result or raises the
        last error.  ``on_retry(attempt, exc)`` fires before each backoff
        sleep (metrics/logging hook); ``sleep`` is injectable for tests.
        """
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except self.retryable as e:
                if attempt + 1 >= self.max_attempts:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(self.delay_s(attempt))
        raise AssertionError("unreachable")  # pragma: no cover
