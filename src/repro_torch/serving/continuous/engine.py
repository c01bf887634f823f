"""Continuous-batching serving engine (DESIGN.md §10).

Counterpart of ``repro.serving.continuous.engine``.
``ServingEngine._serve_retrieval`` joins and evicts at *sequence*
boundaries: a batch of B requests runs all L beam-search levels in
lock-step, and a slot that finishes early idles until the whole batch
drains.  This engine joins and evicts at *step* boundaries: every engine
step decodes one SID level for every live slot, slots freed by completion
are refilled from the queue on the very next step, and all of it happens at
fixed shapes through four entry points (``_prefill``, ``_commit``,
``_admit``, ``_step``), as the reference's four jitted functions.  Prefill
always runs ``prefill_chunk`` rows (padding rows write the NULL page), and
dead slots ride along every step, frozen.

The port compiles nothing; its counterpart of a compile is a
**specialization** (:func:`repro_torch.observability.compile_events`): the
step counts one for each new key ``(policy signature, slots, prompt width,
page size, share width)`` it runs under, as ``GenerativeRetriever``
counts its own.  Warm-up counts 1, a hot swap 0 and a cold swap 1.

The three subsystems:

* **Paged history KV**: each slot's prompt KV lives in pool pages indexed
  through a per-slot page table (``repro_torch.models.kvcache``); ownership
  is a host-side free list with refcounts (:class:`PagedKVAllocator`).  The
  M beams of a slot read ONE stored history copy, and identical prompts
  share pages across slots via :class:`PrefixShareTable`; a hit also skips
  the prefill (prefill rows are independent of each other, so the donor's
  pages and first-token logits are what the skipped prefill would give).
* **Step scheduler** (:class:`StepScheduler`): chunked prefill (at most
  ``prefill_chunk`` fresh prefills per step), SLO deadline shedding at
  admission, and round-robin tenant fairness from ``RequestQueue``'s lanes.
* **Trie-prefix sharing**: rows at different decode levels are masked in
  one call through the policy's level-free path (``dense_d == 0`` node ids
  are unique across levels, so ``(constraint_id, node)`` alone keys the
  admissible set), and ``DecodePolicy.shared_mask_step`` computes one mask
  row per trie node the beams sit on.

Bit-identity contract: per-request ``(sids, scores)`` equal
``ServingEngine``'s bit for bit when every matrix product has the batch
engine's shape (``slots`` and ``prefill_chunk`` equal to its batch size):
the decode step is :func:`~repro_torch.models.transformer.paged_decode_step`
(``decode_step`` op for op), the advance below is ``core.beam_search``'s
dense advance with its stable top-M, and a product's rows may round
differently at another row count, on the card and on the CPU alike.

All device work runs on the caller's current stream; every tensor the
engine holds is allocated there, and each step ends in a synchronize (the
step's wall time is measured to its end, as the reference blocks on it).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.beam_search import top_m
from repro_torch.core.vntk import NEG_INF
from repro_torch.models import kvcache as kv_lib
from repro_torch.models import transformer
from repro_torch.observability import (
    MetricsRegistry,
    annotate,
    compile_events,
    record_policy,
)
from repro_torch.observability.timing import record_specialization
from repro_torch.reliability.faults import InjectedFault, fire
from repro_torch.serving.continuous.paged_kv import (
    PagedKVAllocator,
    PrefixShareTable,
)
from repro_torch.serving.continuous.scheduler import (
    StepScheduler,
    queue_push_back,
)
from repro_torch.serving.engine import _EngineMetrics
from repro_torch.serving.generative_retrieval import _signature

__all__ = ["ContinuousServingEngine"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ContinuousServingEngine:
    """Step-boundary continuous batching over a constrained retriever.

    Built from the same :class:`GenerativeRetriever` the batch engine
    serves (the retriever contributes params, config, policy and the SID
    geometry; its own retrieve is not used), on the retriever's device.
    The policy must support level-free masking: build its constraint index
    with ``dense_d=0``.
    """

    def __init__(self, retriever, *, registry=None, slots: int = 8,
                 prompt_width: int = 8, page_size: int = 8,
                 prefill_chunk: int = 2, share_width: Optional[int] = None,
                 share_capacity: int = 64, deadline_s: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None, breaker=None,
                 admit_retry_budget: int = 3):
        self.retriever = retriever
        self.breaker = breaker
        self.admit_retry_budget = int(admit_retry_budget)
        self.params = retriever.params
        self.cfg: TransformerConfig = retriever.cfg
        self.policy = retriever.policy
        self.device = retriever.device
        self.L, self.V, self.M = retriever.L, retriever.V, retriever.M
        self.S = int(prompt_width)
        self.n_slots = int(slots)
        self.page_size = int(page_size)
        self.share_width = share_width
        self.registry = registry
        self._installed_version = None
        if not self.policy.supports_level_free:
            raise ValueError(
                "continuous batching requires a level-free-capable policy: "
                "build the constraint index with dense_d=0 "
                f"(got [{self.policy.describe()}])")

        self._m = _EngineMetrics(metrics)
        r = self._m.registry
        record_policy(r, self.policy, beams=self.M)
        self._page_util = r.gauge(
            "serving_kv_page_pool_utilization",
            "referenced fraction of the paged history KV pool")
        self._slot_reuse = r.counter(
            "serving_slot_reuse_total",
            "admissions into a slot that already served a request "
            "(continuous batching working: > 0 under any sustained load)")
        self._share_hits = r.counter(
            "serving_prefix_share_hits_total",
            "work units saved by sharing: kind=\"prompt\" = prefills "
            "skipped via the prompt-prefix table; kind=\"mask_row\" = "
            "VNTK mask rows deduped across beams on the same trie node")
        self._admissions = r.counter(
            "serving_admissions_total", "requests admitted into a slot")

        self.sched = StepScheduler(
            self.n_slots, self.L, prefill_chunk=prefill_chunk,
            deadline_s=deadline_s)
        self.n_hist_pages = kv_lib.pages_for(self.S, self.page_size)
        n_pages = 1 + (self.n_slots + self.sched.prefill_chunk
                       + int(share_capacity)) * self.n_hist_pages
        self.alloc = PagedKVAllocator(n_pages)
        self.share = PrefixShareTable(self.alloc, capacity=share_capacity)

        # -- device state (engine-owned, written only by the entry points) --
        cfg, dev = self.cfg, self.device
        dtype = transformer.torch_dtype(cfg)
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
        self._k_pool, self._v_pool = kv_lib.init_page_pool(
            cfg.n_layers, n_pages, self.page_size, kv, hd, dtype=dtype,
            device=dev)
        suffix = (cfg.n_layers, self.n_slots, self.M, self.L + 1, kv, hd)
        self._suffix_k = torch.zeros(suffix, dtype=dtype, device=dev)
        self._suffix_v = torch.zeros(suffix, dtype=dtype, device=dev)
        self._tokens = torch.zeros((self.n_slots, self.M, self.L),
                                   dtype=torch.int32, device=dev)
        self._scores = torch.full((self.n_slots, self.M), NEG_INF,
                                  dtype=torch.float32, device=dev)
        self._nodes = torch.ones((self.n_slots, self.M), dtype=torch.int32,
                                 device=dev)
        self._first_lp = torch.zeros((self.n_slots, self.V),
                                     dtype=torch.float32, device=dev)
        self._share_acc = torch.zeros((), dtype=torch.int64, device=dev)
        self._share_flushed = 0
        self._unique = []  # the policy's key count of each step, on device
        self.unique_per_step: list[int] = []  # ... read back at serve's end
        self._specializations = set()  # step keys run under
        # host mirrors: page ownership + per-slot constraint ids
        self._page_table = np.zeros((self.n_slots, self.n_hist_pages),
                                    np.int32)
        self._slot_pages: list[tuple[int, ...]] = [()] * self.n_slots
        self._cids = np.zeros(self.n_slots, np.int32)
        self._warm = False
        with torch.inference_mode():
            self._warmup()

    @property
    def metrics(self) -> MetricsRegistry:
        return self._m.registry

    @property
    def slots(self) -> int:
        """Concurrent-request capacity (the other engines' batch size)."""
        return self.n_slots

    @property
    def num_sets(self) -> Optional[int]:
        return self.policy.num_sets

    @property
    def cold_swaps(self) -> int:
        return int(self._m.cold.total())

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------
    # the four entry points
    # ------------------------------------------------------------------
    def _prefill(self, prompts: np.ndarray):
        """(A, S) prompts -> (first SID logits (A, V) f32, per-layer K/V
        rows (n_layers, A, S, KVH, Dh))."""
        logits, cache = transformer.prefill(
            self.params, self._dev(prompts.astype(np.int64)), self.cfg,
            max_len=self.S)
        return logits[:, 0, :self.V], cache.k, cache.v

    def _commit(self, ks, vs, page_ids: np.ndarray) -> None:
        ids = self._dev(page_ids)
        kv_lib.scatter_pages(self._k_pool, ks, ids)
        kv_lib.scatter_pages(self._v_pool, vs, ids)

    def _admit_rows(self, admit: np.ndarray, new_first: np.ndarray) -> None:
        """Reset admitted slots to beam search's initial state (the
        ``_init_state`` of ``core.beam_search``: scores [0, NEG_INF, ...],
        nodes at ROOT=1, tokens zeroed) and zero their suffixes, in place
        and without a host sync (selects, no boolean indexing)."""
        adm = self._dev(admit)
        init = torch.full((self.M,), NEG_INF, dtype=torch.float32,
                          device=self.device)
        init[0] = 0.0
        self._tokens.masked_fill_(adm[:, None, None], 0)
        self._scores.copy_(torch.where(adm[:, None], init, self._scores))
        self._nodes.masked_fill_(adm[:, None], 1)
        self._first_lp.copy_(torch.where(adm[:, None], self._dev(new_first),
                                         self._first_lp))
        adm6 = adm[None, :, None, None, None, None]
        self._suffix_k.masked_fill_(adm6, 0)
        self._suffix_v.masked_fill_(adm6, 0)

    def _step(self, levels_np: np.ndarray, live_np: np.ndarray) -> None:
        """One decode level for every live slot, at its own level.

        Dead slots ride along with frozen outputs: their suffix writes land
        in the trash column and their beam state is select-frozen, so they
        cost compute but never change bits.
        """
        key = (_signature(self.policy), self.n_slots, self.S, self.page_size,
               self.share_width)
        if key not in self._specializations:
            self._specializations.add(key)
            record_specialization()
        policy, dev = self.policy, self.device
        slots, M, L, V, S = self.n_slots, self.M, self.L, self.V, self.S
        N, Ls = slots * M, L + 1
        levels = self._dev(levels_np.astype(np.int64))
        live = self._dev(live_np)
        # a live row at level l >= 1 attends positions [0, S + l - 1]:
        # exactly the sequential cache's position at decode step l
        col = (levels - 1).clamp(0, L - 1)
        pos = S + col
        write_col = torch.where(live & (levels > 0), levels - 1, Ls - 1)
        last = self._tokens.gather(
            2, col[:, None, None].expand(slots, M, 1))[:, :, 0]
        logits_raw, self._suffix_k, self._suffix_v = \
            transformer.paged_decode_step(
                self.params, self._k_pool, self._v_pool,
                self._dev(self._page_table), self._suffix_k, self._suffix_v,
                last, pos, write_col, self.cfg, hist_len=S)
        logits = logits_raw[:, 0, :V].reshape(slots, M, V)
        # level-0 slots take the prefill's first-token logits (beam search
        # step 0): the same row for every beam, as the broadcast gives it
        logits = torch.where((levels == 0)[:, None, None],
                             self._first_lp[:, None, :], logits)

        nodes_flat = self._nodes.reshape(N)
        cids_flat = (self._dev(self._cids).repeat_interleave(M)
                     if policy.requires_constraint_ids else None)
        masked, next_dense, n_unique = policy.shared_mask_step(
            logits.reshape(N, V), nodes_flat, constraint_ids=cids_flat,
            share_width=self.share_width)
        self._unique.append(n_unique)

        # the dense beam advance of core.beam_search
        total = self._scores[:, :, None] + masked.reshape(slots, M, V)
        top_scores, top_idx = top_m(total.reshape(slots, M * V), M)
        beam_idx = top_idx // V
        token = (top_idx % V).to(torch.int32)
        batch_ix = torch.arange(slots, device=dev)[:, None]
        new_nodes = next_dense.reshape(slots, M, V)[
            batch_ix, beam_idx, token.long()]
        new_tokens = self._tokens[batch_ix, beam_idx]
        wmask = (torch.arange(L, device=dev)[None, None, :]
                 == levels[:, None, None])
        new_tokens = torch.where(wmask, token[:, :, None], new_tokens)

        self._tokens = torch.where(live[:, None, None], new_tokens,
                                   self._tokens)
        self._scores = torch.where(live[:, None], top_scores, self._scores)
        self._nodes = torch.where(live[:, None], new_nodes.to(torch.int32),
                                  self._nodes)
        # beam-permute the decoded suffixes (history pages are the same for
        # every beam of a slot, so only the suffixes need the gather)
        perm = torch.where(live[:, None], beam_idx,
                           torch.arange(M, device=dev)[None, :])
        flat = (batch_ix * M + perm).reshape(N)
        shape = self._suffix_k.shape
        self._suffix_k = self._suffix_k.reshape(
            shape[0], N, *shape[3:]).index_select(1, flat).reshape(shape)
        self._suffix_v = self._suffix_v.reshape(
            shape[0], N, *shape[3:]).index_select(1, flat).reshape(shape)

        # prefix-share accounting among LIVE rows only: dead rows get
        # per-row unique sentinel keys, so they neither join a share class
        # nor inflate the saved-row count
        keys = nodes_flat.long()
        if cids_flat is not None:
            keys = cids_flat.long() * (policy.constraints.n_states + 1) + keys
        live_flat = live.repeat_interleave(M)
        keys = torch.where(live_flat, keys,
                           -1 - torch.arange(N, device=dev))
        sorted_keys = torch.sort(keys).values
        n_uni = 1 + (sorted_keys[1:] != sorted_keys[:-1]).sum()
        n_live = live_flat.sum()
        self._share_acc += (n_live - (n_uni - (N - n_live))).clamp(min=0)

    # ------------------------------------------------------------------
    # host-side plumbing
    # ------------------------------------------------------------------
    def _warmup(self):
        """Run every entry point once before serving (the reference's
        compile-at-warm-up; here the step's first specialization), with no
        slot admitted."""
        A = self.sched.prefill_chunk
        _, ks, vs = self._prefill(np.zeros((A, self.S), np.int32))
        self._commit(ks, vs, np.zeros((A, self.n_hist_pages), np.int32))
        self._admit_rows(np.zeros(self.n_slots, bool),
                         np.zeros((self.n_slots, self.V), np.float32))
        self._run_step()
        _sync(self.device)
        self._unique.clear()
        self._warm = True

    def _run_step(self):
        self._step(self.sched.levels(), self.sched.live_mask())

    def _install_current_store(self):
        """Adopt the registry's front buffer, as
        ``ServingEngine._install_current_store`` does: hot = the policy's
        signature is unchanged (no new specialization), cold = the step
        specializes exactly once.  Called only between steps, each of
        which ended in a synchronize, so no kernel still reads the store
        this replaces."""
        store, version = self.registry.current()
        cold = False
        if version != self._installed_version:
            before = _signature(self.policy)
            new_policy = self.policy.with_constraints(store)
            if not new_policy.supports_level_free:
                raise ValueError(
                    "registry store lost level-free support (rebuild the "
                    "registry with dense_d=0)")
            self.policy = new_policy
            cold = _signature(new_policy) != before
            if cold:
                self._m.cold.inc()
                record_policy(self._m.registry, self.policy, beams=self.M)
            else:
                self._m.hot.inc()
            self._installed_version = version
            self._m.store_version.set(version)
        return version, cold

    def _padded_prompt(self, request) -> np.ndarray:
        row = np.zeros(self.S, np.int32)
        n = min(request.prompt.shape[0], self.S)
        row[:n] = request.prompt[:n]
        return row

    def _alloc_pages(self) -> list[int]:
        try:
            return self.alloc.alloc(self.n_hist_pages)
        except (MemoryError, InjectedFault):
            # reclaim cached-but-unused prompt KV and retry once (an
            # injected kv.page_alloc fault models the same transient
            # exhaustion; alloc's fault point fires before any mutation,
            # so the free/referenced invariant is intact here)
            self.share.drop_all()
            return self.alloc.alloc(self.n_hist_pages)

    def _admit(self, queue, admissions, fresh):
        """Run the bounded prefill chunk, wire page ownership, and reset the
        admitted slots' device rows.

        A request whose page allocation fails even after the share-table
        reclaim is NOT admitted and does NOT crash the step: it goes back on
        the queue with a bumped ``admit_attempts``, and once the retry
        budget is spent it is shed with reason ``kv_pages`` (degradation
        ladder, DESIGN.md §13).  Other admissions in the chunk proceed.
        """
        now = time.monotonic()
        admit_mask = np.zeros(self.n_slots, bool)
        new_first = np.zeros((self.n_slots, self.V), np.float32)
        if fresh:
            ok = []
            for slot, r in fresh:
                try:
                    pages = self._alloc_pages()
                except (MemoryError, InjectedFault):
                    if self.breaker is not None:
                        self.breaker.record_failure()
                    r.admit_attempts += 1
                    if r.admit_attempts >= self.admit_retry_budget:
                        queue.shed(r, "kv_pages")
                    else:
                        queue_push_back(queue, r)
                    continue
                self._slot_pages[slot] = tuple(pages)
                ok.append((slot, r))
            dropped = {id(r) for _, r in fresh} - {id(r) for _, r in ok}
            if dropped:
                admissions = [a for a in admissions if id(a[1]) not in dropped]
            fresh = ok
        if fresh:
            A = self.sched.prefill_chunk
            block = np.zeros((A, self.S), np.int32)
            page_ids = np.zeros((A, self.n_hist_pages), np.int32)  # pad->NULL
            for j, (slot, r) in enumerate(fresh):
                block[j] = self._padded_prompt(r)
                page_ids[j] = self._slot_pages[slot]
            first_dev, ks, vs = self._prefill(block)
            self._commit(ks, vs, page_ids)
            first_host = first_dev.cpu().numpy()  # (A, V) float32, exact
            for j, (slot, r) in enumerate(fresh):
                new_first[slot] = first_host[j]
                self.share.insert(
                    block[j], self._slot_pages[slot], first_host[j])
        num_sets = self.policy.num_sets
        for slot, r, hit in admissions:
            limit = num_sets if num_sets is not None else 1
            if not 0 <= r.constraint_id < limit:
                raise ValueError(
                    f"request {r.rid}: constraint_id {r.constraint_id} "
                    f"outside [0, {limit})")
            if hit:
                entry = self.share.lookup(self._padded_prompt(r))
                if entry is None:
                    # donor entry vanished between planning and admission
                    # (drop_all reclaim under page pressure): requeue as a
                    # fresh prefill for the next step instead of crashing
                    queue_push_back(queue, r)
                    continue
                pages, first_row = entry
                self._slot_pages[slot] = pages
                new_first[slot] = first_row
                self._share_hits.inc(kind="prompt")
            self._page_table[slot, :] = self._slot_pages[slot]
            self._cids[slot] = r.constraint_id
            if self.sched.slots[slot].served > 0:
                self._slot_reuse.inc()
            self._admissions.inc(lane=str(r.constraint_id))
            admit_mask[slot] = True
            self.sched.admit(slot, r, now)
        self._admit_rows(admit_mask, new_first)

    def _flush_share_hits(self):
        total = int(self._share_acc)
        if total > self._share_flushed:
            self._share_hits.inc(
                total - self._share_flushed, kind="mask_row")
            self._share_flushed = total
        if self._unique:
            self.unique_per_step = torch.stack(self._unique).tolist()
            self._unique.clear()

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def serve(self, queue, max_steps: int = 50_000) -> dict:
        """Drain the queue; returns ``{rid: {sids, scores, constraint_id,
        store_version, latency_s, queue_s}}`` (the ServingEngine schema)
        plus ``{rid: {"error": ...}}`` for shed requests.
        ``unique_per_step`` then holds the policy's key count of each step
        this call ran."""
        with torch.inference_mode():
            return self._serve(queue, max_steps)

    def _serve(self, queue, max_steps: int) -> dict:
        results: dict[int, dict] = {}
        sched = self.sched
        steps = 0
        self._m.record_shed(queue, results)  # submit-time refusals
        while (len(queue) or sched.n_live) and steps < max_steps:
            version, cold = (self._install_current_store()
                             if self.registry is not None else (None, False))
            sched.shed_expired(queue)  # sweeps ALL lanes, stages into queue
            admissions, fresh = sched.plan_admissions(
                queue, lambda r: self.share.contains(self._padded_prompt(r)))
            if admissions or fresh:
                self._admit(queue, admissions, fresh)
            self._m.record_shed(queue, results)
            self._m.sample_queue(queue)
            if sched.n_live == 0:
                if not len(queue):
                    break
                continue

            c0 = compile_events()
            t0 = time.monotonic()
            try:
                fire("decode.slow_step")  # delay => slow step; error => retry
                with annotate("continuous_step"):
                    self._run_step()
                    _sync(self.device)
            except InjectedFault:
                # the fault fired before the step touched any engine state,
                # so retrying it next iteration is bit-identical; the failed
                # attempt still burns a step of the budget so an "always"
                # error fault cannot spin forever
                if self.breaker is not None:
                    self.breaker.record_failure()
                steps += 1
                continue
            except Exception:
                if self.breaker is not None:
                    self.breaker.record_failure()
                raise
            if self.breaker is not None:
                self.breaker.record_success()
            dt = time.monotonic() - t0
            steps += 1
            sched.advance()
            self._m.record_batch(
                n_active=sched.n_live, slots=self.n_slots, steps=1, dt=dt,
                compiles=compile_events() - c0, expected=cold or not self._warm)

            done = sched.completed()
            if done:
                # copies: on the CPU, .cpu() would alias the engine's state
                toks = self._tokens.cpu().numpy().copy()
                scs = self._scores.cpu().numpy().copy()
                t_done = time.monotonic()
                for i in done:
                    st = sched.evict(i)
                    r = st.request
                    self.alloc.release(self._slot_pages[i])
                    self._slot_pages[i] = ()
                    self._page_table[i, :] = 0
                    results[r.rid] = {
                        "sids": toks[i],
                        "scores": scs[i],
                        "constraint_id": r.constraint_id,
                        "store_version": self._installed_version,
                        **self._m.record_request(
                            r, st.t_admit, t_done, t_first=st.t_first,
                            n_out=self.L),
                    }
            self._m.occupancy.set(sched.n_live / max(self.n_slots, 1))
            self._page_util.set(self.alloc.utilization())
        self._m.record_shed(queue, results)
        self._m.sample_queue(queue)
        self._flush_share_hits()
        return results
