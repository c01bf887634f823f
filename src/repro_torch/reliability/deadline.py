"""Per-request deadline propagation (DESIGN.md §13).

A copy of ``repro.reliability.deadline`` (host-only Python, no tensors).

A :class:`Deadline` is an *absolute* ``time.monotonic()`` instant fixed at
submit time, so it means the same thing at every layer it rides through —
enqueue-time admission, queue residence, scheduler planning — without
re-anchoring arithmetic.  All checks take an optional ``now`` so tests and
the chaos harness can drive virtual time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

__all__ = ["Deadline"]


@dataclasses.dataclass(frozen=True)
class Deadline:
    """Absolute monotonic-clock deadline."""

    t_deadline: float

    @classmethod
    def after(cls, seconds: float,
              now: Optional[float] = None) -> "Deadline":
        now = time.monotonic() if now is None else now
        return cls(now + float(seconds))

    def remaining(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return self.t_deadline - now

    def expired(self, now: Optional[float] = None) -> bool:
        return self.remaining(now) <= 0.0
