"""Circuit breaker + admission control: the shed rung of the degradation
ladder (DESIGN.md §13).

A copy of ``repro.reliability.breaker`` (host-only Python, no tensors).

The ladder is **retry → serve-stale constraints → shed at admission** and
it stops there: a request is *never* served with constrained decoding
disabled.  Unconstrained fallback would turn a transient infrastructure
fault into user-visible constraint violations (stale/ineligible items
surfaced), which is the one failure mode the paper's production claim
rules out — shedding is visible, bounded, and recoverable; a violation is
none of those.

:class:`CircuitBreaker` tracks consecutive service failures
(CLOSED → OPEN after ``failure_threshold``), denies admission while OPEN,
probes after ``recovery_s`` (HALF_OPEN), and closes again after
``half_open_successes`` consecutive probe successes.  State and
transitions land in ``circuit_breaker_state`` /
``circuit_breaker_transitions_total{from,to}``.

:class:`AdmissionController` is the enqueue-time gate the
``RequestQueue`` consults: breaker state, queue depth, already-expired
deadlines, and (optionally) a constraint-staleness bound each map to a
shed *reason* — one shared ``requests_shed_total{reason}`` family across
all three engines.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["CircuitBreaker", "AdmissionController", "CLOSED", "OPEN",
           "HALF_OPEN"]

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker with timed half-open probing."""

    def __init__(self, *, failure_threshold: int = 5,
                 recovery_s: float = 1.0, half_open_successes: int = 2,
                 name: str = "serving", metrics=None,
                 now_fn: Callable[[], float] = time.monotonic):
        if failure_threshold < 1 or half_open_successes < 1:
            raise ValueError("thresholds must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.recovery_s = float(recovery_s)
        self.half_open_successes = int(half_open_successes)
        self.name = name
        self._now = now_fn
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0   # consecutive, in CLOSED
        self._successes = 0  # consecutive, in HALF_OPEN
        self._opened_at = 0.0
        self._m_state = self._m_transitions = None
        if metrics is not None:
            self._m_state = metrics.gauge(
                "circuit_breaker_state",
                "0=closed, 1=half_open, 2=open, by breaker name")
            self._m_transitions = metrics.counter(
                "circuit_breaker_transitions_total",
                "breaker state changes, labeled from/to")
            self._m_state.set(0, name=self.name)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, new: str) -> None:
        # lock held by caller
        old, self._state = self._state, new
        if self._m_state is not None:
            self._m_state.set(_STATE_CODE[new], name=self.name)
            self._m_transitions.inc(
                **{"name": self.name, "from": old, "to": new})

    def allow(self, now: Optional[float] = None) -> bool:
        """May a new request be admitted right now?  OPEN transitions to
        HALF_OPEN here once ``recovery_s`` has elapsed (probe traffic)."""
        now = self._now() if now is None else now
        with self._lock:
            if self._state == OPEN:
                if now - self._opened_at >= self.recovery_s:
                    self._successes = 0
                    self._transition(HALF_OPEN)
                    return True
                return False
            return True

    def record_success(self, now: Optional[float] = None) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._successes += 1
                if self._successes >= self.half_open_successes:
                    self._failures = 0
                    self._transition(CLOSED)
            else:
                self._failures = 0

    def record_failure(self, now: Optional[float] = None) -> None:
        now = self._now() if now is None else now
        with self._lock:
            if self._state == HALF_OPEN:
                self._opened_at = now
                self._transition(OPEN)  # a probe failed: re-open
                return
            if self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._opened_at = now
                    self._transition(OPEN)


class AdmissionController:
    """Enqueue-time shed decisions; returns a reason string or None.

    Reasons (the label values of ``requests_shed_total{reason}``):
    ``breaker_open``, ``overload``, ``deadline``, ``stale_constraints``.
    """

    def __init__(self, *, breaker: Optional[CircuitBreaker] = None,
                 max_queue_depth: Optional[int] = None,
                 staleness_fn: Optional[Callable[[], float]] = None,
                 staleness_bound_s: Optional[float] = None):
        self.breaker = breaker
        self.max_queue_depth = max_queue_depth
        self.staleness_fn = staleness_fn
        self.staleness_bound_s = staleness_bound_s

    def admit_reason(self, queue_len: int, *, deadline=None,
                     now: Optional[float] = None) -> Optional[str]:
        if deadline is not None and deadline.expired(now):
            return "deadline"
        if self.breaker is not None and not self.breaker.allow(now):
            return "breaker_open"
        if self.max_queue_depth is not None and \
                queue_len >= self.max_queue_depth:
            return "overload"
        if self.staleness_fn is not None and \
                self.staleness_bound_s is not None and \
                self.staleness_fn() > self.staleness_bound_s:
            return "stale_constraints"
        return None
