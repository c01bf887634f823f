"""Step-boundary slot scheduler for the continuous engine (DESIGN.md §10).

A copy of ``repro.serving.continuous.scheduler``: pure host bookkeeping,
no tensors.  The engine owns the device tensors; this class owns *which
request sits in which slot and how far along it is*, so its policies
(deadline shedding, chunked admission, eviction ordering) are
unit-testable without a model.

Timeline of one engine step::

    evict(levels == L)  ->  admit(free slots, <= prefill_chunk fresh)  ->
    one decode step over ALL slots  ->  levels[live] += 1

Levels advance deterministically (every live slot emits exactly one SID
token per step), so scheduling never reads device state.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

__all__ = ["SlotState", "StepScheduler"]


@dataclasses.dataclass
class SlotState:
    """Host mirror of one batch slot."""
    request: object = None  # serving Request, None when free
    level: int = 0  # SID tokens emitted so far (== next decode level)
    live: bool = False
    t_admit: float = 0.0
    t_first: Optional[float] = None  # wall time level 0 -> 1 completed
    served: int = 0  # completed requests this slot has hosted (reuse count)


class StepScheduler:
    """Admission / eviction planner over ``n_slots`` fixed slots.

    ``prefill_chunk`` caps *fresh prefills* per step — the chunked-prefill
    knob: a burst of long-prompt admissions costs at most one bounded
    ``(A, S)`` prefill per step instead of stalling running decodes behind
    an unbounded one.  Prompt-share hits skip prefill entirely and are not
    counted against the chunk.

    ``deadline_s`` (None = off) sheds requests whose queue wait already
    exceeds the SLO *at admission time* — the cheapest point to drop load,
    before any device work is spent on them.
    """

    def __init__(self, n_slots: int, sid_length: int, *,
                 prefill_chunk: int = 2, deadline_s: Optional[float] = None):
        self.n_slots = int(n_slots)
        self.L = int(sid_length)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.deadline_s = deadline_s
        self.slots = [SlotState() for _ in range(self.n_slots)]

    # -- queries ------------------------------------------------------------
    @property
    def n_live(self) -> int:
        return sum(s.live for s in self.slots)

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.live]

    def live_mask(self) -> np.ndarray:
        return np.array([s.live for s in self.slots], bool)

    def levels(self) -> np.ndarray:
        return np.array([s.level for s in self.slots], np.int32)

    def completed(self) -> list[int]:
        """Slots whose request has emitted all ``L`` tokens (evict next)."""
        return [i for i, s in enumerate(self.slots)
                if s.live and s.level >= self.L]

    # -- transitions --------------------------------------------------------
    def shed_expired(self, queue, now: Optional[float] = None) -> list:
        """Shed every queued request already past its deadline.

        Delegates to :meth:`RequestQueue.shed_expired`, which sweeps ALL
        lanes in place, with the enqueue-to-admission deadline semantics
        every engine shares.
        Per-request :class:`~repro_torch.reliability.Deadline`\\ s are always
        honored; the scheduler's ``deadline_s`` is the engine-level default
        for requests submitted without one.  Returns the shed requests; the
        engine surfaces them via ``_EngineMetrics.record_shed``.
        """
        return queue.shed_expired(now=now, default_deadline_s=self.deadline_s)

    def plan_admissions(self, queue, share_probe) -> tuple[list, list]:
        """Fill free slots from the queue at this step boundary.

        ``share_probe(request) -> bool`` says whether the prompt is a
        prefix-share hit (no prefill needed).  Returns
        ``(admissions, fresh)`` where ``admissions`` is ``[(slot, request,
        is_share_hit)]`` and ``fresh`` the subset needing prefill — its
        length is capped at ``prefill_chunk``.
        """
        admissions, fresh = [], []
        for slot in self.free_slots():
            if not len(queue):
                break
            nxt = queue_peek(queue)
            hit = nxt is not None and share_probe(nxt)
            if not hit and len(fresh) >= self.prefill_chunk:
                break  # chunk full: long-prompt burst waits a step
            r = queue.pop()
            if r is None:
                break
            if r is not nxt:
                # the peeked head expired between peek and pop (deadline
                # shed inside pop): re-probe the request we actually got
                hit = share_probe(r)
                if not hit and len(fresh) >= self.prefill_chunk:
                    queue_push_back(queue, r)
                    break
            admissions.append((slot, r, hit))
            if not hit:
                fresh.append((slot, r))
        return admissions, fresh

    def admit(self, slot: int, request, now: Optional[float] = None) -> None:
        s = self.slots[slot]
        assert not s.live, f"admit into live slot {slot}"
        s.request = request
        s.level = 0
        s.live = True
        s.t_admit = time.monotonic() if now is None else now
        s.t_first = None

    def advance(self, now: Optional[float] = None) -> None:
        """One decode step happened: every live slot emitted a token."""
        now = time.monotonic() if now is None else now
        for s in self.slots:
            if s.live:
                if s.level == 0:
                    s.t_first = now
                s.level += 1

    def evict(self, slot: int) -> SlotState:
        s = self.slots[slot]
        assert s.live and s.level >= self.L, f"evict of unfinished slot {slot}"
        done = dataclasses.replace(s)
        s.request, s.level, s.live, s.t_first = None, 0, False, None
        s.served += 1
        return done


# -- queue helpers (RequestQueue has no peek/push-front; keep them here so
#    the queue class stays minimal) -----------------------------------------
def queue_peek(queue):
    peek = getattr(queue, "peek", None)
    if peek is not None:
        return peek()  # sheds expired heads, so peek/pop stay consistent
    if not queue._rr:
        return None
    return queue._lanes[queue._rr[0]][0]


def queue_push_back(queue, request) -> None:
    """Re-enqueue an already-constructed Request preserving its metadata."""
    lane = queue._lanes.get(request.constraint_id)
    if lane is None:
        lane = queue._lanes[request.constraint_id] = deque()
    if not lane:
        queue._rr.append(request.constraint_id)
    lane.append(request)
    queue._len += 1
