"""The port's compile counter: specializations of the retrieve step.

The reference counts XLA ``backend_compile`` events (``jax.monitoring``) to
turn its "hot swaps never recompile" promise (DESIGN.md §4, §7) into a
monitored invariant.  The port compiles nothing at run time; its
counterpart of a compile is a **specialization**:
``GenerativeRetriever.retrieve`` running under a key it has not run under
before, the key being ``(_signature(policy), history shape, whether
constraint ids are given)``.  Anything keyed on those shapes and static
fields (a captured CUDA graph, say) would have to be rebuilt at exactly
these points.  So a retriever's first batch counts 1, a hot swap 0, and a
cold (regrown-envelope) swap 1.

:func:`compile_events` is the process-wide count, as the reference's is;
:class:`RecompileDetector` is its snapshot-delta view.
"""
from __future__ import annotations

import threading

__all__ = ["RecompileDetector", "compile_events", "record_specialization"]

_lock = threading.Lock()
_count = 0


def record_specialization() -> None:
    """Count one specialization (called by the retriever on a new key)."""
    global _count
    with _lock:
        _count += 1


def compile_events() -> int:
    """Specializations observed process-wide."""
    with _lock:
        return _count


class RecompileDetector:
    """Snapshot-delta view of :func:`compile_events`.

    >>> det = RecompileDetector()   # arms (and snapshots) immediately
    >>> ...                         # run the supposedly-stable step
    >>> det.count                   # 0 unless something specialized

    Also usable as a context manager; ``reset()`` re-arms in place.
    """

    def __init__(self):
        self._start = compile_events()

    def reset(self) -> None:
        self._start = compile_events()

    @property
    def count(self) -> int:
        return compile_events() - self._start

    def __enter__(self) -> "RecompileDetector":
        self.reset()
        return self

    def __exit__(self, *exc) -> None:
        pass
