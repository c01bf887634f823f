"""Batched serving engine: prefill + decode over fixed-size batches.

Counterpart of ``repro.serving.engine``.  ``ServingEngine.generate`` drives
the model's prefill and decode step over a fixed batch (the reference's two
``jax.jit`` calls become direct calls to
:func:`~repro_torch.models.transformer.prefill` and
:func:`~repro_torch.models.transformer.decode_step`).  The
``RequestQueue`` admits requests into free slots at step boundaries, so the
batch stays full under load.

Multi-tenant retrieval mode (DESIGN.md §4): built with a ``retriever`` (and
optionally a ``registry``), every request's ``constraint_id`` rides through
the queue into the shared batch, and one constrained beam search serves
rows under different constraint sets at once.  The registry's current
store is read at every batch boundary and installed with
``retriever.set_constraints``: a hot swap takes effect on the next batch
with no new specialization of the retrieve step (no tensor shape or static
field changes).  A **cold** swap (the registry regrew the capacity envelope,
DESIGN.md §7) changes static fields: the retriever specializes exactly once
(counted in ``cold_swaps``), and serving drains without dropping requests.

Telemetry (DESIGN.md §9): every engine owns (or is handed) a
:class:`~repro_torch.observability.MetricsRegistry`.  Request latency is
recorded in host-side histograms per tenant lane (queue wait, service,
total), with batch occupancy, per-lane queue depth, decode-step counters
and a **specialization monitor**: specializations
(:func:`~repro_torch.observability.compile_events`, the port's compile
counter) outside an expected window (the engine's first batch, a cold
swap) increment ``serving_recompiles_total{expected="false"}``, which must
stay 0.  All instrumentation runs on the host, around the device calls.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.models import transformer
from repro_torch.observability import (
    TOKEN_LATENCY_BUCKETS_S,
    MetricsRegistry,
    annotate,
    compile_events,
    record_policy,
)
from repro_torch.reliability.deadline import Deadline
from repro_torch.reliability.faults import InjectedFault, fire

__all__ = ["ServingEngine", "RequestQueue", "Request"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    n_tokens: int
    constraint_id: int = 0  # which registry slot masks this request's SIDs
    t_enqueue: float = 0.0  # time.monotonic() at submit (latency accounting)
    deadline: Optional[Deadline] = None  # absolute SLO bound (DESIGN.md §13)
    admit_attempts: int = 0  # failed admission tries (page-alloc retry budget)


class RequestQueue:
    """Per-constraint-slot FIFO lanes drained round-robin.

    The old single deque was strict FIFO: under batched admission a tenant
    that bursts ``batch_size`` requests monopolizes whole batches, and every
    other constraint slot waits a full batch *per queued burst* — unbounded
    in burst length.  Requests now land in one FIFO lane per
    ``constraint_id`` and ``pop`` rotates across non-empty lanes, so a mixed
    batch admits every active tenant each cycle (arrival order is preserved
    *within* a lane, and a single-tenant queue degenerates to plain FIFO).

    **Reliability (DESIGN.md §13).**  ``submit`` is the admission-control
    point for every engine: an optional per-request ``deadline_s`` becomes
    an absolute :class:`~repro_torch.reliability.Deadline`, an optional
    :class:`~repro_torch.reliability.AdmissionController` (breaker state, depth
    cap, staleness bound) may refuse the request, and the
    ``queue.overload`` fault point models an overloaded admission path.
    Refused requests are *shed*, never raised: they collect in an internal
    list with their reason, and the serving engine drains them via
    :meth:`drain_shed` into error results plus the shared
    ``requests_shed_total{reason}`` counter family.  ``pop``/``peek`` also
    shed requests whose deadline expired *while queued*, and
    :meth:`shed_expired` sweeps every lane (not just the head) so a
    deadline deep inside a burst cannot hide behind fresher traffic.
    """

    def __init__(self, *, admission=None):
        self._lanes: dict[int, deque] = {}
        self._rr: deque = deque()  # round-robin order of non-empty lanes
        self._next = 0
        self._len = 0
        self._admission = admission  # AdmissionController (optional)
        self._shed: list[tuple[Request, str]] = []

    def submit(self, prompt: np.ndarray, n_tokens: int,
               constraint_id: int = 0,
               deadline_s: Optional[float] = None) -> int:
        rid = self._next
        self._next += 1
        now = time.monotonic()
        deadline = (Deadline.after(deadline_s, now)
                    if deadline_s is not None else None)
        r = Request(rid, np.asarray(prompt, np.int32), n_tokens,
                    constraint_id, t_enqueue=now, deadline=deadline)
        reason = None
        try:
            fire("queue.overload")
        except InjectedFault:
            reason = "overload"
        if reason is None and self._admission is not None:
            reason = self._admission.admit_reason(
                self._len, deadline=deadline, now=now)
        if reason is None and deadline is not None and deadline.expired(now):
            reason = "deadline"
        if reason is not None:
            self._shed.append((r, reason))
            return rid
        lane = self._lanes.get(constraint_id)
        if lane is None:
            lane = self._lanes[constraint_id] = deque()
        if not lane:
            self._rr.append(constraint_id)
        lane.append(r)
        self._len += 1
        return rid

    def pop(self) -> Optional[Request]:
        while self._rr:
            cid = self._rr.popleft()
            lane = self._lanes[cid]
            r = lane.popleft()
            if lane:
                self._rr.append(cid)  # rotate: next pop serves another tenant
            self._len -= 1
            if r.deadline is not None and r.deadline.expired():
                self._shed.append((r, "deadline"))
                continue  # expired while queued: shed, keep popping
            return r
        return None

    def peek(self) -> Optional[Request]:
        """Next request ``pop`` would return, without removing it (expired
        heads are shed on the way, so peek/pop agree)."""
        while self._rr:
            cid = self._rr[0]
            lane = self._lanes[cid]
            r = lane[0]
            if r.deadline is None or not r.deadline.expired():
                return r
            lane.popleft()
            self._len -= 1
            self._shed.append((r, "deadline"))
            if not lane:
                self._rr.popleft()
        return None

    def shed_expired(self, now: Optional[float] = None,
                     default_deadline_s: Optional[float] = None) -> list:
        """Sweep EVERY lane for expired requests (the old continuous-engine
        check only saw the queue head).  Requests without their own deadline
        fall back to ``default_deadline_s`` measured from enqueue (the
        engine-level SLO knob).  Returns the shed requests; they are also
        staged for :meth:`drain_shed`."""
        now = time.monotonic() if now is None else now
        shed = []
        for cid, lane in self._lanes.items():
            if not lane:
                continue
            survivors = []
            for r in lane:
                if r.deadline is not None:
                    late = r.deadline.expired(now)
                else:
                    late = (default_deadline_s is not None
                            and now - r.t_enqueue > default_deadline_s)
                if late:
                    shed.append(r)
                    self._shed.append((r, "deadline"))
                else:
                    survivors.append(r)
            if len(survivors) != len(lane):
                self._len -= len(lane) - len(survivors)
                lane.clear()
                lane.extend(survivors)
        if shed:
            self._rr = deque(
                cid for cid in self._rr if self._lanes[cid])
        return shed

    def shed(self, request: Request, reason: str) -> None:
        """Stage an already-popped request as shed (e.g. the continuous
        engine's page-allocation retry budget ran out); surfaced by the
        next :meth:`drain_shed`."""
        self._shed.append((request, reason))

    def drain_shed(self) -> list:
        """Return-and-clear ``[(request, reason)]`` of everything shed since
        the last drain (submit-time refusals + queued-deadline expiries)."""
        out, self._shed = self._shed, []
        return out

    def pop_batch(self, n: int) -> list:
        """Up to ``n`` requests, round-robin across constraint slots."""
        out = []
        while len(out) < n:
            r = self.pop()
            if r is None:
                break
            out.append(r)
        return out

    def lane_depths(self) -> dict[int, int]:
        """Current depth of every lane ever seen (emptied lanes report 0,
        so sampled gauges fall back to zero instead of going stale)."""
        return {cid: len(lane) for cid, lane in self._lanes.items()}

    def __len__(self):
        return self._len


class _EngineMetrics:
    """Shared instrumentation for both serving engines (host-side only)."""

    def __init__(self, registry: Optional[MetricsRegistry]):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self.requests = r.counter(
            "serving_requests_total", "requests completed, by tenant lane")
        self.rejected = r.counter(
            "serving_rejected_total", "requests rejected at admission")
        self.shed = r.counter(
            "requests_shed_total",
            "requests shed before service, by reason (deadline/breaker_open/"
            "overload/stale_constraints/kv_pages) — shared across all engines")
        self.latency = r.histogram(
            "serving_request_latency_seconds",
            "per-request enqueue→complete wall time")
        self.queue_wait = r.histogram(
            "serving_request_queue_seconds",
            "per-request enqueue→admit wait in the RequestQueue")
        self.service = r.histogram(
            "serving_request_service_seconds",
            "per-request admit→complete service time")
        self.ttft = r.histogram(
            "serving_request_ttft_seconds",
            "per-request enqueue→first emitted SID token (sequence-boundary "
            "engines emit all tokens at completion, so there ttft == total)",
            buckets=TOKEN_LATENCY_BUCKETS_S)
        self.tpot = r.histogram(
            "serving_request_tpot_seconds",
            "per-request service time per output token",
            buckets=TOKEN_LATENCY_BUCKETS_S)
        self.batch_s = r.histogram(
            "serving_batch_seconds", "wall time of one shared decode batch")
        self.batches = r.counter("serving_batches_total", "batches served")
        self.steps = r.counter(
            "serving_decode_steps_total", "constrained decode steps executed")
        self.occupancy = r.gauge(
            "serving_batch_occupancy",
            "active-slot fraction of the last shared batch")
        self.queue_depth = r.gauge(
            "serving_queue_depth", "queued requests, by tenant lane")
        self.cold = r.counter(
            "serving_cold_swaps_total",
            "envelope regrowths (expected single recompiles) routed through "
            "this engine")
        self.hot = r.counter(
            "serving_hot_swaps_total",
            "zero-recompile registry store installs")
        self.recompiles = r.counter(
            "serving_recompiles_total",
            "retrieve specializations during serving (the port's compiles); "
            "expected=\"false\" must stay 0 (the hot-swap invariant)")
        self.store_version = r.gauge(
            "serving_store_version", "registry version currently installed")

    def sample_queue(self, queue) -> None:
        for cid, depth in queue.lane_depths().items():
            self.queue_depth.set(depth, lane=str(cid))

    def record_shed(self, queue, results: dict) -> int:
        """Drain the queue's shed list into error results + counters.

        Every engine calls this each serve cycle so shed requests surface
        as ``{"error": ..., "reason": ...}`` results instead of silently
        vanishing, and the shared ``requests_shed_total{reason}`` family
        counts them uniformly across engines.
        """
        shed = queue.drain_shed()
        for r, reason in shed:
            self.rejected.inc(lane=str(r.constraint_id))
            self.shed.inc(reason=reason)
            results[r.rid] = {
                "error": f"shed before admission: {reason}",
                "reason": reason,
                "constraint_id": r.constraint_id,
            }
        return len(shed)

    def record_batch(self, *, n_active: int, slots: int, steps: int,
                     dt: float, compiles: int, expected: bool) -> None:
        self.batches.inc()
        self.steps.inc(steps)
        self.batch_s.observe(dt)
        self.occupancy.set(n_active / max(slots, 1))
        if compiles:
            self.recompiles.inc(
                compiles, expected="true" if expected else "false")

    def record_request(self, r: Request, t_admit: float, t_done: float, *,
                       t_first: Optional[float] = None,
                       n_out: Optional[int] = None) -> dict:
        """``t_first`` = wall time the first output token existed (defaults
        to ``t_done``: sequence-boundary engines only surface tokens at batch
        completion); ``n_out`` = output tokens, for the per-token rate."""
        lane = str(r.constraint_id)
        wait = max(t_admit - r.t_enqueue, 0.0)
        total = max(t_done - r.t_enqueue, 0.0)
        self.requests.inc(lane=lane)
        self.queue_wait.observe(wait, lane=lane)
        self.service.observe(max(t_done - t_admit, 0.0), lane=lane)
        self.latency.observe(total, lane=lane)
        self.ttft.observe(
            max((t_done if t_first is None else t_first) - r.t_enqueue, 0.0),
            lane=lane)
        if n_out:
            self.tpot.observe(
                max(t_done - t_admit, 0.0) / max(int(n_out), 1), lane=lane)
        return {"latency_s": total, "queue_s": wait}


class ServingEngine:
    """Serves on the device of ``params`` (and of the retriever's tables)."""

    def __init__(self, params, cfg: TransformerConfig, batch_size: int,
                 max_len: int, *, retriever=None, registry=None,
                 metrics: Optional[MetricsRegistry] = None, breaker=None):
        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_len = max_len
        self.device = params["emb"].device
        self.retriever = retriever  # GenerativeRetriever: SID serving mode
        self.registry = registry  # ConstraintRegistry: hot-swappable store
        self.breaker = breaker  # CircuitBreaker: step outcomes feed it
        self._installed_version = None
        self._m = _EngineMetrics(metrics)
        self._served_batches = 0
        if retriever is not None:
            record_policy(self._m.registry, retriever.policy,
                          beams=retriever.M)

    @property
    def metrics(self) -> MetricsRegistry:
        return self._m.registry

    @property
    def cold_swaps(self) -> int:
        """Envelope regrowths routed through this engine (the
        ``serving_cold_swaps_total`` counter)."""
        return int(self._m.cold.total())

    # -- the model's two calls ----------------------------------------------
    def _prefill(self, prompts: np.ndarray):
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.device)
        return transformer.prefill(self.params, tokens, self.cfg,
                                   max_len=self.max_len)

    def _decode(self, cache, tok: torch.Tensor):
        return transformer.decode_step(self.params, cache, tok, self.cfg)

    # -- single-batch synchronous generation --------------------------------
    def generate(self, prompts: np.ndarray, n_tokens: int,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """``(B, n_tokens)`` int32 tokens: greedy, or sampled from the
        softmax of the logits with ``generator`` (required then, on the
        engine's device), so a seed fixes the draw."""
        B, S = prompts.shape
        if B != self.batch_size:
            raise ValueError(f"batch of {B} prompts, engine batch "
                             f"{self.batch_size}")
        if not greedy and generator is None:
            raise ValueError("sampling needs an explicit torch.Generator")
        with torch.inference_mode():
            logits, cache = self._prefill(prompts)
            tok = logits[:, -1, :].argmax(-1, keepdim=True)
            out = [tok]
            for _ in range(n_tokens - 1):
                logits, cache = self._decode(cache, tok)
                if greedy:
                    tok = logits[:, -1, :].argmax(-1, keepdim=True)
                else:
                    tok = torch.multinomial(
                        torch.softmax(logits[:, -1, :].float(), dim=-1), 1,
                        generator=generator)
                out.append(tok)
            return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()

    # -- registry store install ---------------------------------------------
    def _install_current_store(self):
        """Adopt the registry's front buffer; returns (version, was_cold).

        Called only between batches: the previous batch's ``retrieve`` ended
        in ``.cpu()``, so no kernel still reads the store this replaces.
        """
        store, version = self.registry.current()
        cold = False
        if version != self._installed_version:
            cold = self.retriever.set_constraints(store)
            if cold:
                self._m.cold.inc()
                record_policy(self._m.registry, self.retriever.policy,
                              beams=self.retriever.M)
            else:
                self._m.hot.inc()
            self._installed_version = version
            self._m.store_version.set(version)
        return version, cold

    # -- constrained SID retrieval over a queue -------------------------------
    def _serve_retrieval(self, queue: RequestQueue) -> dict:
        """Drain the queue through the constrained retriever in shared batches.

        Each batch mixes requests with different ``constraint_id``s; the
        per-slot id vector rides into the stacked beam search, so every row's
        SIDs are masked by its own constraint set.  The registry (when
        present) is consulted once per batch, the boundary at which a
        swapped store becomes visible.
        """
        results: dict[int, dict] = {}
        S = self.max_len // 2  # fixed prompt width => fixed shapes
        self._m.record_shed(queue, results)  # submit-time refusals
        while len(queue):
            t_admit = time.monotonic()
            queue.shed_expired()
            batch = queue.pop_batch(self.batch_size)
            self._m.record_shed(queue, results)
            self._m.sample_queue(queue)
            if not batch:
                continue
            version, cold = None, False
            if self.registry is not None:
                version, cold = self._install_current_store()
            # A plain single-matrix retriever serves every request under the
            # one set: constraint ids stay host-side and must all be 0.
            num_sets = self.retriever.num_sets
            hist = np.zeros((self.batch_size, S), np.int32)
            cids = np.zeros(self.batch_size, np.int32)
            for i, r in enumerate(batch):
                hist[i, : min(r.prompt.shape[0], S)] = r.prompt[:S]
                limit = num_sets if num_sets is not None else 1
                if not 0 <= r.constraint_id < limit:
                    raise ValueError(
                        f"request {r.rid}: constraint_id {r.constraint_id} "
                        f"outside [0, {limit})"
                    )
                cids[i] = r.constraint_id
            c0 = compile_events()
            try:
                fire("decode.slow_step")  # delay => slow batch; error => fail
                with annotate("serve_batch"):
                    beams, scores = self.retriever.retrieve(
                        hist,
                        constraint_ids=cids if num_sets is not None else None,
                    )
            except InjectedFault:
                # A failed decode step degrades to failed requests, never to
                # unconstrained decoding or an engine crash (DESIGN.md §13).
                if self.breaker is not None:
                    self.breaker.record_failure()
                for r in batch:
                    self._m.rejected.inc(lane=str(r.constraint_id))
                    self._m.shed.inc(reason="decode_fault")
                    results[r.rid] = {
                        "error": "decode step failed (injected fault)",
                        "reason": "decode_fault",
                        "constraint_id": r.constraint_id,
                    }
                continue
            except Exception:
                if self.breaker is not None:
                    self.breaker.record_failure()
                raise
            if self.breaker is not None:
                self.breaker.record_success()
            t_done = time.monotonic()
            self._m.record_batch(
                n_active=len(batch), slots=self.batch_size,
                steps=self.retriever.L, dt=t_done - t_admit,
                compiles=compile_events() - c0,
                expected=cold or self._served_batches == 0,
            )
            self._served_batches += 1
            for i, r in enumerate(batch):
                results[r.rid] = {
                    "sids": beams[i],
                    "scores": scores[i],
                    "constraint_id": r.constraint_id,
                    "store_version": version,
                    **self._m.record_request(r, t_admit, t_done,
                                             n_out=self.retriever.L),
                }
        self._m.record_shed(queue, results)
        self._m.sample_queue(queue)
        return results

    # -- continuous batching over a queue ------------------------------------
    def serve(self, queue: RequestQueue, max_steps: int = 10_000) -> dict:
        """Run until the queue drains.

        Plain-LM mode returns {rid: generated token list} (greedy); retrieval
        mode (engine built with a ``retriever``) returns {rid: {sids, scores,
        constraint_id, store_version, latency_s, queue_s}}.
        """
        if self.retriever is not None:
            return self._serve_retrieval(queue)
        with torch.inference_mode():
            return self._serve_lm(queue, max_steps)

    def _serve_lm(self, queue: RequestQueue, max_steps: int) -> dict:
        results: dict[int, list] = {}
        self._m.record_shed(queue, results)  # submit-time refusals
        active: list[Optional[Request]] = [None] * self.batch_size
        admit_t: dict[int, float] = {}
        remaining = np.zeros(self.batch_size, np.int64)
        prompts = np.zeros((self.batch_size, self.max_len // 2), np.int32)

        def admit():
            changed = False
            now = time.monotonic()
            for i in range(self.batch_size):
                if active[i] is None and len(queue):
                    r = queue.pop()
                    if r is None:  # remaining requests expired while queued
                        break
                    active[i] = r
                    remaining[i] = r.n_tokens
                    prompts[i, :] = 0
                    prompts[i, : r.prompt.shape[0]] = r.prompt
                    results[r.rid] = []
                    admit_t[r.rid] = now
                    changed = True
            self._m.sample_queue(queue)
            return changed

        steps = 0
        while (any(a is not None for a in active) or len(queue)) \
                and steps < max_steps:
            admit()
            self._m.occupancy.set(
                sum(a is not None for a in active) / max(self.batch_size, 1)
            )
            # (re)prefill the whole batch when composition changed
            logits, cache = self._prefill(prompts)
            tok = logits[:, -1, :].argmax(-1, keepdim=True)
            while any(a is not None for a in active):
                steps += 1
                self._m.steps.inc()
                tok_np = tok[:, 0].cpu().numpy()
                done_any = False
                for i, r in enumerate(active):
                    if r is None:
                        continue
                    results[r.rid].append(int(tok_np[i]))
                    remaining[i] -= 1
                    if remaining[i] <= 0:
                        self._m.record_request(
                            r, admit_t.pop(r.rid, r.t_enqueue),
                            time.monotonic())
                        active[i] = None
                        done_any = True
                if done_any and len(queue):
                    break  # re-admit + re-prefill with new composition
                if not any(a is not None for a in active) \
                        or steps >= max_steps:
                    break
                logits, cache = self._decode(cache, tok)
                tok = logits[:, -1, :].argmax(-1, keepdim=True)
        return results
