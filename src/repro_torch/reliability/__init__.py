"""Fault injection, retry, deadlines and admission control (DESIGN.md §13).

Host-only copies of ``repro.reliability``'s modules that the batch engine
and the refresher use (``HealthMonitor`` is not ported yet):

* :mod:`~repro_torch.reliability.faults` — seeded deterministic
  :class:`FaultInjector` over the named fault points; production code
  queries :func:`fire` (one load and a ``None`` check when disabled).
* :mod:`~repro_torch.reliability.retry` — :class:`RetryPolicy`, capped
  exponential backoff with deterministic jitter (the refresher adopts it).
* :mod:`~repro_torch.reliability.deadline` — absolute per-request
  :class:`Deadline`.
* :mod:`~repro_torch.reliability.breaker` — :class:`CircuitBreaker` and
  :class:`AdmissionController`: the shed rung of the degradation ladder
  (retry → serve-stale → shed; never unconstrained decoding).
"""
from repro_torch.reliability.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    AdmissionController,
    CircuitBreaker,
)
from repro_torch.reliability.deadline import Deadline
from repro_torch.reliability.faults import (
    FAULT_POINTS,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    active_injector,
    fire,
    install,
    uninstall,
)
from repro_torch.reliability.retry import RetryPolicy

__all__ = [
    "FAULT_POINTS",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "active_injector",
    "fire",
    "install",
    "uninstall",
    "RetryPolicy",
    "Deadline",
    "CircuitBreaker",
    "AdmissionController",
    "CLOSED",
    "HALF_OPEN",
    "OPEN",
]
