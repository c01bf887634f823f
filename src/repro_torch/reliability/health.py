"""Readiness/liveness signal for the metrics HTTP server (DESIGN.md §13).

A host-only copy of ``repro.reliability.health``.

:class:`HealthMonitor` folds breaker state and constraint staleness into
one ``(ready, payload)`` answer.  ``repro_torch.observability.start_http_server``
serves it at ``/healthz`` (200 when ready, 503 otherwise, JSON body either
way) next to ``/metrics``; ``/livez`` always answers 200 — the process is
alive exactly when it can answer at all.

Readiness semantics:

* breaker OPEN → not ready (new work would be shed anyway; a load
  balancer should stop routing here until the breaker half-opens);
* ``constraint_staleness_seconds > staleness_bound_s`` → not ready (the
  store is still *valid* — last-good-version serving continues for
  in-flight traffic — but it is too old to keep advertising this replica
  as healthy).

Degraded-but-serving (stale under the bound, breaker CLOSED/HALF_OPEN)
stays ready: that is the serve-stale rung of the ladder working.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.reliability.breaker import OPEN, CircuitBreaker

__all__ = ["HealthMonitor"]


class HealthMonitor:
    """Callable ``() -> (ready, payload_dict)`` for the health endpoint."""

    def __init__(self, *, breaker: Optional[CircuitBreaker] = None,
                 staleness_fn: Optional[Callable[[], float]] = None,
                 staleness_bound_s: Optional[float] = None,
                 metrics=None):
        self.breaker = breaker
        self.staleness_fn = staleness_fn
        self.staleness_bound_s = staleness_bound_s
        self._m_ready = None
        if metrics is not None:
            self._m_ready = metrics.gauge(
                "serving_ready",
                "1 when /healthz reports ready (breaker not open, "
                "constraint staleness within bound)")

    def check(self) -> tuple[bool, dict]:
        state = self.breaker.state if self.breaker is not None else None
        stale = (float(self.staleness_fn())
                 if self.staleness_fn is not None else 0.0)
        reasons = []
        if state == OPEN:
            reasons.append("breaker_open")
        if self.staleness_bound_s is not None and \
                stale > self.staleness_bound_s:
            reasons.append("stale_constraints")
        ready = not reasons
        if self._m_ready is not None:
            self._m_ready.set(1.0 if ready else 0.0)
        payload = {
            "ready": ready,
            "reasons": reasons,
            "breaker": state if state is not None else "absent",
            "constraint_staleness_seconds": stale,
            "staleness_bound_s": self.staleness_bound_s,
        }
        return ready, payload

    __call__ = check
