"""Deterministic fault injection for the serving stack (DESIGN.md §13).

A copy of ``repro.reliability.faults`` (host-only Python, no tensors).

Production code asks :func:`fire` at a handful of *named fault points*;
when no injector is installed the call is one module-global load plus a
``None`` check — cheap enough to leave compiled into every hot path.  A
chaos run installs a :class:`FaultInjector` built from a seeded schedule
and the exact same binaries start failing in a *bit-reproducible* way:
each point keeps its own call counter and its own counter-keyed RNG
stream, so which calls fire depends only on (schedule, seed, per-point
call index) — never on wall clock, thread interleaving across points, or
the host's global RNG state.

Two fault kinds:

* **error** — :func:`fire` raises :class:`InjectedFault`.  The production
  code must treat it exactly like the organic failure the point models
  (``refresh.build`` ~ predicate/build error, ``kv.page_alloc`` ~ pool
  exhaustion, ``queue.overload`` ~ admission-control rejection, ...).
* **delay** (``delay_s > 0``) — :func:`fire` sleeps and returns.  Models a
  slow dependency (``decode.slow_step``, a stalling ``tiering.host_fetch``)
  without changing any result bits.

Schedules are plain data (:meth:`FaultInjector.from_json`), so a saved
schedule replays a byte-identical campaign.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = [
    "FAULT_POINTS",
    "InjectedFault",
    "FaultSpec",
    "FaultInjector",
    "fire",
    "install",
    "uninstall",
    "active_injector",
]

#: The closed registry of fault points (DESIGN.md §13 documents each one's
#: blast radius and required degradation behavior).  ``fire`` rejects
#: unknown names at schedule-construction time, so a typo cannot silently
#: produce a fault-free "chaos" run.
FAULT_POINTS = frozenset({
    "refresh.build",      # registry slot rebuild (predicate eval / trie)
    "refresh.swap",       # the front-buffer flip about to happen
    "tiering.host_fetch", # host-tier cold-edge gather
    "kv.page_alloc",      # paged-KV pool allocation
    "decode.slow_step",   # jitted decode step dispatch (delay-only)
    "queue.overload",     # RequestQueue admission
})


class InjectedFault(RuntimeError):
    """Raised by :func:`fire` for an error-kind fault."""

    def __init__(self, point: str, call_index: int):
        super().__init__(f"injected fault at {point} (call {call_index})")
        self.point = point
        self.call_index = call_index


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled failure mode at one fault point.

    ``mode``:
      * ``"nth"``    — fire exactly on the 0-based per-point call indices
        listed in ``calls``;
      * ``"always"`` — fire on every call (bounded by ``max_fires``);
      * ``"prob"``   — fire each call with probability ``p`` drawn from a
        per-point counter-keyed stream (deterministic per call index).

    ``delay_s > 0`` makes this a delay fault (sleep, don't raise);
    ``max_fires`` caps total fires (``None`` = unbounded) — e.g.
    ``mode="always", max_fires=2`` models "fails twice, then recovers",
    the canonical transient a retry policy must absorb.
    """

    point: str
    mode: str = "nth"
    calls: tuple = ()
    p: float = 0.0
    delay_s: float = 0.0
    max_fires: Optional[int] = None

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; known: "
                f"{sorted(FAULT_POINTS)}")
        if self.mode not in ("nth", "always", "prob"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.mode == "prob" and not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        object.__setattr__(self, "calls", tuple(int(c) for c in self.calls))


class FaultInjector:
    """Seeded, deterministic fault scheduler over the point registry.

    Thread-safe: points are hit from the refresher worker, the tiering
    prefetcher and the serving thread concurrently, but every decision is
    a function of the *per-point* call index, so cross-point thread
    interleaving cannot change which calls fire.

    ``on_fire(point, call_index, spec)`` runs synchronously before the
    fault takes effect — the chaos harness uses it to check the allocator
    invariant at the exact moment of each injection.
    """

    def __init__(self, specs: Sequence[FaultSpec], *, seed: int = 0,
                 on_fire: Optional[Callable] = None):
        self.seed = int(seed)
        self.on_fire = on_fire
        self._lock = threading.Lock()
        self._specs: dict[str, list[FaultSpec]] = {}
        for s in specs:
            self._specs.setdefault(s.point, []).append(s)
        self._calls: dict[str, int] = {p: 0 for p in self._specs}
        self._fired: dict[int, int] = {id(s): 0 for p in self._specs
                                       for s in self._specs[p]}
        self.fires: list[tuple[str, int, str]] = []  # (point, idx, kind)

    # -- deterministic per-(point, call) uniform draw ----------------------
    def _uniform(self, point: str, idx: int) -> float:
        key = [self.seed, zlib.crc32(point.encode()), idx]
        return float(np.random.default_rng(key).random())

    def calls(self, point: str) -> int:
        with self._lock:
            return self._calls.get(point, 0)

    def n_fires(self, point: Optional[str] = None) -> int:
        with self._lock:
            if point is None:
                return len(self.fires)
            return sum(1 for p, _, _ in self.fires if p == point)

    def fire(self, point: str) -> None:
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}")
        specs = self._specs.get(point)
        if not specs:
            return
        with self._lock:
            idx = self._calls[point]
            self._calls[point] = idx + 1
            hit = None
            for s in specs:
                if s.max_fires is not None and \
                        self._fired[id(s)] >= s.max_fires:
                    continue
                if s.mode == "nth" and idx in s.calls:
                    hit = s
                elif s.mode == "always":
                    hit = s
                elif s.mode == "prob" and \
                        self._uniform(point, idx) < s.p:
                    hit = s
                if hit is not None:
                    break
            if hit is None:
                return
            self._fired[id(hit)] += 1
            kind = "delay" if hit.delay_s > 0 else "error"
            self.fires.append((point, idx, kind))
        if self.on_fire is not None:
            self.on_fire(point, idx, hit)
        if hit.delay_s > 0:
            time.sleep(hit.delay_s)
            return
        raise InjectedFault(point, idx)

    # -- schedule (de)serialization ----------------------------------------
    @classmethod
    def from_json(cls, source, *, on_fire: Optional[Callable] = None
                  ) -> "FaultInjector":
        """Build from a dict, a JSON string, or a path to a JSON file::

            {"seed": 0, "faults": [
              {"point": "decode.slow_step", "mode": "prob",
               "p": 0.2, "delay_s": 0.005},
              {"point": "refresh.build", "mode": "always", "max_fires": 2},
              {"point": "kv.page_alloc", "mode": "nth", "calls": [3, 7]}]}
        """
        if isinstance(source, dict):
            doc = source
        else:
            text = str(source)
            if text.lstrip().startswith("{"):
                doc = json.loads(text)
            else:
                with open(text) as f:
                    doc = json.load(f)
        specs = [FaultSpec(**entry) for entry in doc.get("faults", [])]
        return cls(specs, seed=int(doc.get("seed", 0)), on_fire=on_fire)


# ---------------------------------------------------------------------------
# the global hook production code queries
# ---------------------------------------------------------------------------
_ACTIVE: Optional[FaultInjector] = None


def fire(point: str) -> None:
    """Hit a fault point.  No injector installed: one load + None check."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(point)


def install(injector: FaultInjector) -> None:
    global _ACTIVE
    _ACTIVE = injector


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextmanager
def active_injector(injector: Optional[FaultInjector]):
    """Scoped install; restores the previous injector on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = injector
    try:
        yield injector
    finally:
        _ACTIVE = prev
