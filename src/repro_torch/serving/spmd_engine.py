"""SPMD constrained serving: mesh-parallel retrieval + continuous batching
(``repro.serving.spmd_engine``).

``SpmdRetriever`` is the :class:`~repro_torch.serving.generative_retrieval
.GenerativeRetriever` made SPMD over a process mesh
(:mod:`repro_torch.launch.mesh`): every rank of the mesh calls
``retrieve`` with the same global batch, runs prefill + the L constrained
beam steps on its own block of rows along the mesh's data axes, and one
all-gather returns the global results to every rank.  Rows are independent
in Algorithm 1, so the rows a rank decodes are bit-identical to a
single-device retrieve of those rows.  The DecodePolicy's placement comes
from its ``shardings(mesh)`` hook: replicated by default (paper §A.3; on
the card every rank runs the CUDA VNTK kernels), or CSR-row-sharded along
``model`` with ``rows="model"`` for tries that outgrow one device
(DESIGN.md §6): each rank then holds ``1/ms`` of the edge slab and its
sparse steps run the plain-torch one-hop all-reduce of
:mod:`repro_torch.distributed.constraint_sharding`.

``SpmdServingEngine`` drains a request queue through the retriever in
continuous data-parallel batches:

  * a **global batch of fixed ``slots``** (rounded up to a multiple of the
    data-parallel ways), so occupancy changes never change a shape;
  * per-row ``constraint_ids`` and an ``active`` mask: free slots are
    inactive rows whose scores come back ``NEG_INF``;
  * round-robin admission across constraint slots
    (:class:`~repro_torch.serving.engine.RequestQueue` lanes);
  * the registry's current store is read at each batch boundary and
    installed with ``retriever.set_constraints``: a hot swap changes only
    tensor values, so the retrieve step counts no new specialization.

With a world of one rank and a ``(1, 1)`` mesh every collective is the
identity and both classes equal their single-device counterparts bit for
bit.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.vntk import NEG_INF
from repro_torch.decoding.backends import CpuTrieBackend
from repro_torch.distributed.constraint_sharding import (
    ModelShard,
    gather_dp,
    pad_policy_rows,
    shard_policy,
    to_row_sharded,
)
from repro_torch.distributed.sharding import dp_rank, dp_size
from repro_torch.observability import (
    MetricsRegistry,
    annotate,
    compile_events,
    record_policy,
)
from repro_torch.observability.timing import record_specialization
from repro_torch.reliability.faults import InjectedFault, fire
from repro_torch.serving.engine import _EngineMetrics
from repro_torch.serving.generative_retrieval import (
    GenerativeRetriever,
    _signature,
)

__all__ = ["SpmdRetriever", "SpmdServingEngine"]


class SpmdRetriever(GenerativeRetriever):
    """Mesh-parallel constrained retrieval.

    Same constructor surface as :class:`GenerativeRetriever` plus ``mesh``
    and ``rows`` (the CSR placement, see the backends' ``shardings``).
    ``retrieve`` pads the request batch to a multiple of the mesh's
    data-parallel ways with inactive rows, so any caller batch size maps
    onto the mesh.  Under ``rows="model"`` ``self.policy`` holds this
    rank's row block of the (padded) slab.
    """

    def __init__(self, params, cfg, policy=None, sid_length=None,
                 sid_vocab=None, beam_size: int = 20, *, mesh,
                 rows: str = "replicated"):
        super().__init__(params, cfg, policy, sid_length, sid_vocab,
                         beam_size)
        if rows not in ("replicated", "model"):
            raise ValueError(
                f"rows must be 'replicated' or 'model', got {rows!r}")
        for b in self.policy.backends:
            if isinstance(b, CpuTrieBackend):
                raise TypeError(
                    "CpuTrieBackend masks on the host and cannot run inside "
                    "the SPMD step; use a device-resident backend (STATIC, "
                    "stacked, PPV, bitmap)")
        self.mesh = mesh
        self.rows = rows
        self._dp_size = dp_size(mesh)
        self._mesh_shape = tuple(mesh.shape)
        self._shard = ModelShard.of(mesh) if rows == "model" else None
        self._install(self.policy)

    def _install(self, policy) -> None:
        """Pad and cut ``policy`` to this rank (``rows="model"``) and keep
        the view the search runs: deterministic shapes, so re-installing
        after a hot swap keeps them."""
        if self.rows == "model":
            to_row_sharded(policy, self._shard)  # impl/fused rejection
            policy = shard_policy(pad_policy_rows(policy, self._shard.size),
                                  self.mesh, rows="model")
            self._run_policy = to_row_sharded(policy, self._shard)
        else:
            self._run_policy = policy
        self.policy = policy

    # -- hot-swap ------------------------------------------------------------
    def set_constraints(self, obj) -> bool:
        """Registry swap under the mesh; returns True iff it was cold.

        A hot swap (envelope-stable, the ConstraintRegistry refresh path)
        changes only tensor values: the swapped-in matrix or store is
        re-padded and re-cut to the same row-block shapes, so the policy's
        signature, and the retrieve's specialization key, stay.  A cold
        swap (regrown envelope, DESIGN.md §7) changes static fields: the
        next retrieve counts exactly one specialization.
        """
        before = _signature(self.policy)
        self._install(self.policy.with_constraints(obj))
        return _signature(self.policy) != before

    # -- serving -------------------------------------------------------------
    def retrieve(self, history: np.ndarray,
                 constraint_ids: Optional[np.ndarray] = None,
                 active_mask: Optional[np.ndarray] = None):
        """history (B, S) -> (sids (B, M, L), scores (B, M)), SPMD.

        Every rank of the mesh calls it with the same arguments and gets
        the same global result.  ``active_mask`` (B,) bool marks real rows
        (default: all).  The batch is padded to a multiple of the
        data-parallel ways with inactive rows; padding is sliced off the
        outputs, and inactive rows return ``NEG_INF`` scores.
        """
        hist = np.asarray(history, np.int32)
        B = hist.shape[0]
        n = self._dp_size
        Bp = -(-B // n) * n
        num_sets = self.num_sets
        cids = np.zeros(Bp, np.int32)
        if constraint_ids is not None:
            cids_in = np.asarray(constraint_ids, np.int32)
            if num_sets is None:
                raise ValueError(
                    "constraint_ids requires a stacked ConstraintStore policy")
            if cids_in.min() < 0 or cids_in.max() >= num_sets:
                raise ValueError(
                    f"constraint_ids must be in [0, {num_sets}), got "
                    f"range [{cids_in.min()}, {cids_in.max()}]")
            cids[:B] = cids_in
        elif num_sets is not None:
            raise ValueError(
                "stacked ConstraintStore policies need per-row constraint_ids")
        active = np.zeros(Bp, bool)
        active[:B] = True if active_mask is None else np.asarray(active_mask,
                                                                 bool)
        if Bp != B:
            hist = np.concatenate(
                [hist, np.zeros((Bp - B, hist.shape[1]), np.int32)])
        b, r = Bp // n, dp_rank(self.mesh)
        rows = slice(r * b, (r + 1) * b)
        key = (_signature(self.policy), self._mesh_shape, self.rows,
               (b, hist.shape[1]), num_sets is not None)
        if key not in self._specializations:
            self._specializations.add(key)
            record_specialization()
        with torch.inference_mode():
            h = torch.as_tensor(hist[rows].astype(np.int64),
                                device=self.device)
            ids = (torch.as_tensor(cids[rows], device=self.device)
                   if num_sets is not None else None)
            tokens, scores = self._retrieve(h, ids, policy=self._run_policy)
            act = torch.as_tensor(active[rows], device=self.device)
            # inactive (padding / free-slot) rows: parked at NEG_INF so no
            # consumer can mistake them for results
            scores = torch.where(act[:, None], scores, NEG_INF)
            tokens, scores = gather_dp(self.mesh, tokens, scores)
            return tokens[:B].cpu().numpy(), scores[:B].cpu().numpy()


class SpmdServingEngine:
    """Continuous data-parallel batched serving over a mesh.

    Drains a :class:`~repro_torch.serving.engine.RequestQueue` through an
    :class:`SpmdRetriever` in fixed-``slots`` global batches; every rank
    serves the same queue and gets the same results.  The result dict
    matches ``ServingEngine.serve``'s retrieval mode:
    ``{rid: {sids, scores, constraint_id, store_version, latency_s,
    queue_s}}``.
    """

    def __init__(self, retriever: SpmdRetriever, *, registry=None,
                 slots: Optional[int] = None, prompt_width: int = 8,
                 metrics: Optional[MetricsRegistry] = None, breaker=None):
        n = retriever._dp_size
        slots = slots if slots is not None else max(2 * n, 4)
        self.slots = -(-slots // n) * n  # static-shape padding rule (§6)
        self.retriever = retriever
        self.registry = registry
        self.breaker = breaker
        self.prompt_width = prompt_width
        self._installed_version = None
        self._m = _EngineMetrics(metrics)
        self._served_batches = 0
        record_policy(self._m.registry, retriever.policy, beams=retriever.M)

    @property
    def metrics(self) -> MetricsRegistry:
        return self._m.registry

    @property
    def cold_swaps(self) -> int:
        """Envelope regrowths routed through this engine (the
        ``serving_cold_swaps_total`` counter)."""
        return int(self._m.cold.total())

    def _install_current_store(self):
        """Adopt the registry's front buffer; returns (version, was_cold)."""
        store, version = self.registry.current()
        cold = False
        if version != self._installed_version:
            cold = self.retriever.set_constraints(store)
            if cold:
                self._m.cold.inc()  # regrown envelope: one specialization
                record_policy(self._m.registry, self.retriever.policy,
                              beams=self.retriever.M)
            else:
                self._m.hot.inc()
            self._installed_version = version
            self._m.store_version.set(version)
        return version, cold

    def serve(self, queue, max_batches: int = 10_000) -> dict:
        results: dict[int, dict] = {}
        S = self.prompt_width
        batches = 0
        self._m.record_shed(queue, results)  # submit-time refusals
        while len(queue) and batches < max_batches:
            batches += 1
            t_admit = time.monotonic()
            queue.shed_expired()
            batch = queue.pop_batch(self.slots)  # round-robin fair admit
            self._m.record_shed(queue, results)
            self._m.sample_queue(queue)
            if not batch:
                continue
            version, cold = None, False
            if self.registry is not None:
                version, cold = self._install_current_store()
            num_sets = self.retriever.num_sets
            limit = num_sets if num_sets is not None else 1
            hist = np.zeros((self.slots, S), np.int32)
            cids = np.zeros(self.slots, np.int32)
            active = np.zeros(self.slots, bool)
            for i, r in enumerate(batch):
                if not 0 <= r.constraint_id < limit:
                    # reject just this request (it raced a registry shrink
                    # or is bad input): killing the drain would discard
                    # every already-served and already-popped row
                    results[r.rid] = {
                        "error": f"constraint_id {r.constraint_id} outside "
                                 f"[0, {limit})",
                        "constraint_id": r.constraint_id,
                        "store_version": version,
                    }
                    self._m.rejected.inc(lane=str(r.constraint_id))
                    continue
                hist[i, : min(r.prompt.shape[0], S)] = r.prompt[:S]
                cids[i] = r.constraint_id
                active[i] = True
            c0 = compile_events()
            try:
                fire("decode.slow_step")  # delay => slow batch; error => fail
                with annotate("spmd_serve_batch"):
                    beams, scores = self.retriever.retrieve(
                        hist,
                        constraint_ids=cids if num_sets is not None else None,
                        active_mask=active)
            except InjectedFault:
                # degrade to failed requests, never to unconstrained
                # decoding or a crashed drain loop (DESIGN.md §13)
                if self.breaker is not None:
                    self.breaker.record_failure()
                for r in batch:
                    if r.rid in results:
                        continue
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
                n_active=int(active.sum()), slots=self.slots,
                steps=self.retriever.L, dt=t_done - t_admit,
                compiles=compile_events() - c0,
                expected=cold or self._served_batches == 0)
            self._served_batches += 1
            for i, r in enumerate(batch):
                if r.rid in results:
                    continue  # rejected above
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
