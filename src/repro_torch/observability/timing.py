"""The port's compile counter and its step timer.

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

:class:`StepTimer` measures a step as the reference's does: ``warmup``
calls absorb the first-call cost, then every trial records two host times,
*dispatch* (until the call returns) and *wall* (until
``torch.cuda.synchronize(device)``, or until the call returns on the CPU),
and the specializations seen during warm-up and during the trials (>0
steady means the step re-specializes per call).  The field names are the
reference's: ``warmup_compiles`` and ``steady_compiles`` count
specializations here.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["RecompileDetector", "compile_events", "record_specialization",
           "StepStats", "StepTimer"]

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


@dataclasses.dataclass
class StepStats:
    """Result of one :meth:`StepTimer.measure` run (times in seconds)."""

    name: str
    wall_s: np.ndarray  # (trials,) synchronized wall time per trial
    dispatch_s: np.ndarray  # (trials,) time-to-return per trial
    warmup_compiles: int  # specializations absorbed by warmup
    steady_compiles: int  # specializations DURING trials: >0 == per call

    @property
    def trials(self) -> int:
        return int(self.wall_s.shape[0])

    @property
    def median(self) -> float:
        return float(np.median(self.wall_s))

    @property
    def p50(self) -> float:
        return self.median

    @property
    def p90(self) -> float:
        return float(np.quantile(self.wall_s, 0.9))

    @property
    def p99(self) -> float:
        return float(np.quantile(self.wall_s, 0.99))

    @property
    def std(self) -> float:
        return float(np.std(self.wall_s))

    @property
    def dispatch_median(self) -> float:
        return float(np.median(self.dispatch_s))

    def summary(self) -> dict:
        return dict(
            name=self.name, trials=self.trials, median_s=self.median,
            p50_s=self.p50, p90_s=self.p90, p99_s=self.p99, std_s=self.std,
            dispatch_median_s=self.dispatch_median,
            warmup_compiles=self.warmup_compiles,
            steady_compiles=self.steady_compiles,
        )


class StepTimer:
    """Measure a step: warm-up, then synchronized trials.

    ``device`` is the card to synchronize (default: the current CUDA
    device when CUDA is available); ``"cpu"`` times until the call returns.
    With a ``registry``, every trial lands in
    ``step_wall_seconds{step=name}`` / ``step_dispatch_seconds{step=name}``
    histograms and specializations in ``step_compiles_total{step,phase}``.
    All accounting is host-side, around the call.
    """

    def __init__(self, name: str = "step", registry=None, *,
                 warmup: int = 3, trials: int = 30, device=None):
        if warmup < 0 or trials < 1:
            raise ValueError("need warmup >= 0 and trials >= 1")
        self.name = name
        self.registry = registry
        self.warmup = warmup
        self.trials = trials
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measure(self, fn, *args, trials: Optional[int] = None,
                warmup: Optional[int] = None) -> StepStats:
        trials = self.trials if trials is None else trials
        warmup = self.warmup if warmup is None else warmup
        c0 = compile_events()
        for _ in range(warmup):
            fn(*args)
            self._sync()
        c1 = compile_events()
        wall = np.empty(trials)
        dispatch = np.empty(trials)
        for i in range(trials):
            t0 = time.perf_counter()
            fn(*args)
            dispatch[i] = time.perf_counter() - t0
            self._sync()
            wall[i] = time.perf_counter() - t0
        c2 = compile_events()
        stats = StepStats(
            name=self.name, wall_s=wall, dispatch_s=dispatch,
            warmup_compiles=c1 - c0, steady_compiles=c2 - c1,
        )
        if self.registry is not None:
            h_wall = self.registry.histogram(
                "step_wall_seconds",
                "synchronized wall time of a timed step")
            h_disp = self.registry.histogram(
                "step_dispatch_seconds",
                "host dispatch time of a timed step (time-to-return)")
            for w, d in zip(wall, dispatch):
                h_wall.observe(float(w), step=self.name)
                h_disp.observe(float(d), step=self.name)
            c = self.registry.counter(
                "step_compiles_total",
                "specializations seen while timing (steady>0 == per call)")
            if stats.warmup_compiles:
                c.inc(stats.warmup_compiles, step=self.name, phase="warmup")
            if stats.steady_compiles:
                c.inc(stats.steady_compiles, step=self.name, phase="steady")
        return stats
