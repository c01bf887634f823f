"""HBM/host tiering for 100M+-SID tries (DESIGN.md §11).

Counterpart of ``repro.constraints.tiering``.  A catalog's deep trie levels
dominate the constraint footprint while serving touches only ``B*M`` of
their rows per step, so the canonical CSR slab is split at a level
boundary:

  * **hot tier**: the dense band and the first sparse levels stay on the
    device; decode steps below the boundary run the ordinary
    :class:`~repro_torch.decoding.DecodePolicy` (the CUDA kernels on a CUDA
    matrix) over an edge slab cut to the hot prefix.  The level-major edge
    layout (``core.trie.LevelBlocks``) makes the cut a single slice.
  * **cold tier**: the deep levels live in host memory as numpy arrays.
    For a cold step, the surviving beam nodes drive a host gather of each
    beam's speculative ``(bmax, 2)`` edge burst (``B*M*bmax`` entries,
    independent of catalog size), which overlaps the decoder's logits and
    lands on the device for :func:`vntk_pregathered`.

Bit-identity: the host gather reproduces exactly the speculative window the
device step reads (zero outside the slab), and :func:`vntk_pregathered` is
the reference scatter without the table lookup, so tiered decoding equals
:func:`~repro_torch.core.beam_search.beam_search` on the untiered policy
bit for bit.

Unlike a JAX slice, ``edges[:cut]`` in torch is a view that keeps the whole
tensor alive, so the hot slab (and the compressed slab's hot prefix) is a
copy with its own storage, and a :class:`TieredTrie` holds no full-size
device edges: ``tier_bytes()`` is what the split keeps on the card.
The capacity model for the split is
:func:`repro_torch.core.memory_model.plan_tiers`.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core.compressed_slab import CompressedSlab
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.core.trie import LevelBlocks, infer_level_blocks
from repro_torch.core.vntk import NEG_INF
from repro_torch.reliability.faults import InjectedFault, fire
from repro_torch.reliability.retry import RetryPolicy

__all__ = [
    "TieredTrie",
    "TriePrefetcher",
    "vntk_pregathered",
    "tiered_beam_search",
]


def vntk_pregathered(log_probs, gathered, lens, vocab: int):
    """Phases 2-4 of Alg. 2 on a pregathered speculative burst.

    ``gathered`` is the ``(nb, bmax, 2)`` ``[token, next_state]`` burst the
    prefetcher staged (zero outside each row's window) and ``lens`` the
    per-row child counts; this is the reference scatter with the table
    gather removed, so outputs equal the untiered mask step's bit for bit.
    Plain torch ops on the tensors' device.
    """
    V = vocab
    batch_shape = tuple(log_probs.shape[:-1])
    lp = log_probs.reshape(-1, V)
    nb, bmax, _ = gathered.shape
    offsets = torch.arange(bmax, dtype=torch.int32, device=lp.device)
    valid = offsets[None, :] < lens.reshape(-1)[:, None]
    cols = gathered[:, :, 0].long()
    nxt = torch.where(valid, gathered[:, :, 1], 0).to(torch.int32)
    scatter_idx = torch.where(valid, cols, V)
    cand_lp = lp.gather(1, cols.clamp(0, V - 1))
    masked = torch.full((nb, V + 1), NEG_INF, dtype=lp.dtype, device=lp.device)
    masked.scatter_(1, scatter_idx, torch.where(valid, cand_lp, NEG_INF))
    next_dense = torch.zeros((nb, V + 1), dtype=torch.int32, device=lp.device)
    next_dense.scatter_(1, scatter_idx, nxt)
    return (masked[:, :V].reshape(batch_shape + (V,)),
            next_dense[:, :V].reshape(batch_shape + (V,)))


@dataclasses.dataclass(frozen=True)
class TieredTrie:
    """Hot/cold split of a single TransitionMatrix at a level boundary.

    ``hot_steps`` is the first COLD decode step: steps ``< hot_steps`` are
    served by the device policy, steps ``>= hot_steps`` by the host tier;
    ``hot_steps == sid_length`` keeps everything on the device.

    ``tm`` is the split matrix: the full matrix's metadata, row pointers and
    dense tables, with ``edges`` the hot prefix's own copy (``max(cold_base,
    1)`` rows, a non-empty gather axis).  ``hot_slab`` is the compressed
    slab of the full matrix with ``tok_delta`` cut the same way.
    """

    tm: TransitionMatrix
    blocks: LevelBlocks
    hot_steps: int
    cold_base: int  # first cold edge index (== hot edge-prefix length)
    edges_cold: np.ndarray  # (E - cold_base, 2) int32, HOST memory
    row_pointers_host: np.ndarray  # (S+1,) int64 HOST copy driving the prefetch
    hot_slab: CompressedSlab

    @classmethod
    def from_matrix(cls, tm: TransitionMatrix, *,
                    hot_steps: Optional[int] = None,
                    hbm_budget: Optional[int] = None) -> "TieredTrie":
        """Split ``tm`` so steps ``>= hot_steps`` read from host memory.

        With ``hot_steps=None`` and an ``hbm_budget`` (bytes), picks the
        deepest boundary whose device bytes (dense tables + row pointers +
        hot edge prefix) fit; with neither, everything stays hot.  The
        compressed slab is built from the full matrix (the canonical one),
        then cut; the full edges are not kept on the device.
        """
        if tm.is_stacked:
            raise NotImplementedError(
                "tiering splits a single TransitionMatrix; tier each "
                "ConstraintStore member before stacking")
        L = tm.sid_length
        d = min(tm.dense_d, L)
        edges_nb = tm.edges.numel() * tm.edges.element_size()
        blocks = infer_level_blocks(
            tm.row_pointers, tm.edges, n_states=tm.n_states,
            n_edges=tm.n_edges, sid_length=L, dense_d=tm.dense_d,
            vocab_size=tm.vocab_size)
        if hot_steps is None:
            if hbm_budget is None:
                hot_steps = L
            else:
                fixed = tm.nbytes() - edges_nb  # dense tables + rp
                hot_steps = d
                for s in range(d, L):
                    prefix = int(blocks.edge_offsets[s + 1]) * 8
                    if fixed + prefix > hbm_budget:
                        break
                    hot_steps = s + 1
        hot_steps = max(d, min(int(hot_steps), L))
        cold_base = int(blocks.edge_offsets[hot_steps])
        cut = max(cold_base, 1)  # keep a non-empty gather axis
        full_slab = CompressedSlab.from_matrix(tm)
        hot_slab = dataclasses.replace(
            full_slab, tok_delta=full_slab.tok_delta[:cut].clone())
        del full_slab
        return cls(
            tm=dataclasses.replace(tm, edges=tm.edges[:cut].clone()),
            blocks=blocks,
            hot_steps=hot_steps,
            cold_base=cold_base,
            edges_cold=np.ascontiguousarray(
                tm.edges[cold_base:tm.n_edges].cpu().numpy(), dtype=np.int32),
            row_pointers_host=tm.row_pointers.cpu().numpy().astype(np.int64),
            hot_slab=hot_slab,
        )

    @property
    def device(self) -> torch.device:
        return self.tm.device

    def hot_policy(self, *, impl: Optional[str] = None, topk: bool = True,
                   compressed: bool = False):
        """DecodePolicy for the hot steps over the cut edge slab.

        ``impl=None`` launches the CUDA kernels on a CUDA matrix (the plain
        versions on a CPU one), ``"plain"`` the plain versions anywhere.
        Both read the hot prefix only below each row's child count, and
        every hot level's edges lie below ``cold_base``; the reference
        refuses its Pallas kernels here because their DMA over-reads.
        ``fused=False``, as in the reference.
        """
        from repro_torch.decoding.backends import StaticBackend
        from repro_torch.decoding.policy import DecodePolicy

        if impl not in (None, "plain"):
            raise ValueError(
                f"tiered decoding takes impl=None (the CUDA kernels) or "
                f"'plain', got {impl!r}")
        pol = DecodePolicy.static(self.tm, impl=impl, fused=False, topk=topk)
        if not compressed:
            return pol
        return dataclasses.replace(pol, backends=tuple(
            dataclasses.replace(b, slab=self.hot_slab)
            if isinstance(b, StaticBackend) and b.levels != "dense" else b
            for b in pol.backends))

    def tier_bytes(self) -> dict:
        """Realized footprint of the split (cf. ``memory_model.plan_tiers``)."""
        hot_edges = int(self.cold_base) * 8
        edges = self.tm.edges  # the hot copy: what remains is dense + rp
        fixed = self.tm.nbytes() - edges.numel() * edges.element_size()
        return dict(
            hot_steps=int(self.hot_steps),
            cold_base=int(self.cold_base),
            hbm_bytes=int(fixed + hot_edges),
            host_bytes=int(self.edges_cold.nbytes),
        )

    def gather_cold(self, nodes: np.ndarray, step: int):
        """Host-side speculative burst for a cold step's beam nodes.

        Returns ``(gathered (nb, bmax, 2) int32, lens (nb,) int32)``: the
        window the device step would read (zeros outside the slab).
        """
        if step < self.hot_steps:
            raise ValueError(f"step {step} is hot (< {self.hot_steps})")
        bmax = max(self.tm.bmax_for_step(step), 1)
        n = np.asarray(nodes, dtype=np.int64).reshape(-1)
        rp = self.row_pointers_host
        starts = rp[n]
        lens = rp[n + 1] - starts
        idx = starts[:, None] + np.arange(bmax, dtype=np.int64)[None, :]
        rel = idx - self.cold_base
        n_cold = self.edges_cold.shape[0]
        in_range = (rel >= 0) & (rel < n_cold)
        g = self.edges_cold[np.clip(rel, 0, max(n_cold - 1, 0))]
        g[~in_range] = 0
        return g.astype(np.int32), lens.astype(np.int32)


class _Staged:
    """A prefetch in flight.  ``result()`` returns ``(gathered, lens)`` on
    the device; on the card it first makes the caller's stream wait for the
    side stream's copy and marks the tensors used there."""

    def __init__(self, future, timings):
        self._future = future
        self._timings = timings

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None):
        t0 = time.perf_counter()
        g, lens, ready, record = self._future.result(timeout)
        record["wait_s"] = time.perf_counter() - t0
        self._timings.append(record)
        if ready is not None:
            stream = torch.cuda.current_stream(g.device)
            stream.wait_event(ready)
            g.record_stream(stream)
            lens.record_stream(stream)
        return g, lens


class TriePrefetcher:
    """Async host->device staging of cold-tier bursts (DESIGN.md §11).

    One worker thread overlaps the host gather and the upload with the
    decoder's logits: the nodes surviving step ``t-1`` fully determine step
    ``t``'s speculative window, so the prefetch is issued as soon as the
    beam advance is queued.  On the card the worker waits on an event
    recorded where the nodes were computed (not on the whole device), reads
    them, gathers on the host into **pinned** buffers and copies them on a
    side stream with ``non_blocking=True``; :meth:`_Staged.result` makes
    the consuming stream wait for that copy.

    A stalling or failing host fetch (the ``tiering.host_fetch`` fault
    point) is retried under ``retry`` on the worker thread, inside the
    overlap window.  A terminal failure surfaces at ``result()``: the
    search stops rather than decode past the constraint (DESIGN.md §13:
    never a fallback to unconstrained decoding).

    ``timings`` holds, for the last ``TIMINGS_KEPT`` consumed fetches, the
    step, the host gather's seconds (``gather_s``, retries included), how
    long the consumer blocked at ``result()`` (``wait_s``, the part the
    overlap did not hide) and, on the card, the pinned staging bytes.
    """

    TIMINGS_KEPT = 1024

    def __init__(self, tiered: TieredTrie, *,
                 retry: Optional[RetryPolicy] = None, metrics=None):
        self.tiered = tiered
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay_s=0.002, max_delay_s=0.05,
            retryable=(InjectedFault, OSError, MemoryError))
        self._m_retries = None
        if metrics is not None:
            self._m_retries = metrics.counter(
                "tiering_fetch_retries_total",
                "host-tier gathers retried after a transient failure")
        self.device = tiered.device
        self.timings = collections.deque(maxlen=self.TIMINGS_KEPT)
        self._stream = None
        initializer = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # the current device is per thread
            initializer = torch.cuda.set_device
        self._pool = ThreadPoolExecutor(
            max_workers=1, initializer=initializer,
            initargs=(self.device,) if initializer else ())

    def prefetch(self, nodes, step: int) -> _Staged:
        """Stage the burst for ``nodes`` at cold ``step``; ``result()`` of
        the returned handle gives device tensors ``(gathered, lens)``."""
        computed = None
        if isinstance(nodes, torch.Tensor) and nodes.is_cuda:
            computed = torch.cuda.Event()
            computed.record(torch.cuda.current_stream(nodes.device))

        def gather():
            fire("tiering.host_fetch")
            if computed is not None:
                computed.synchronize()
            host = (nodes.cpu().numpy() if isinstance(nodes, torch.Tensor)
                    else np.asarray(nodes))
            return self.tiered.gather_cold(host, step)

        def on_retry(attempt, e):
            if self._m_retries is not None:
                self._m_retries.inc()

        def work():
            t0 = time.perf_counter()
            g, lens = self.retry.call(gather, on_retry=on_retry)
            record = dict(step=step, gather_s=time.perf_counter() - t0)
            if self._stream is None:
                return (torch.from_numpy(g).to(self.device),
                        torch.from_numpy(lens).to(self.device), None, record)
            g_pin = torch.from_numpy(g).pin_memory()
            lens_pin = torch.from_numpy(lens).pin_memory()
            with torch.cuda.stream(self._stream):
                g_dev = g_pin.to(self.device, non_blocking=True)
                lens_dev = lens_pin.to(self.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self._stream)
            record.update(pinned=g_pin.is_pinned() and lens_pin.is_pinned(),
                          pinned_bytes=g_pin.nbytes + lens_pin.nbytes)
            return g_dev, lens_dev, ready, record

        return _Staged(self._pool.submit(work), self.timings)

    def close(self):
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def tiered_beam_search(
    logits_fn,
    carry,
    batch_size: int,
    beam_size: int,
    length: int,
    tiered: TieredTrie,
    *,
    policy=None,
    prefetcher: Optional[TriePrefetcher] = None,
    carry_gather_fn=None,
    first_logits: Optional[torch.Tensor] = None,
):
    """Constrained beam search over a tiered trie (Alg. 1, host cold tier).

    Hot steps run ``policy`` (default: ``tiered.hot_policy()``) exactly as
    :func:`~repro_torch.core.beam_search.beam_search` does; cold steps
    consume the prefetcher's staged burst through :func:`vntk_pregathered`.
    ``carry_gather_fn`` and ``first_logits`` are ``beam_search``'s (the
    reference's tiered search has neither; a model with a KV cache needs
    both).  Returns ``(BeamState, carry)``, bit-identical to the untiered
    search.
    """
    from repro_torch.core.beam_search import BeamState, _init_state, top_m

    if policy is None:
        policy = tiered.hot_policy()
    own_prefetcher = prefetcher is None
    if own_prefetcher:
        prefetcher = TriePrefetcher(tiered)
    B, M = batch_size, beam_size
    device = first_logits.device if first_logits is not None else tiered.device
    state = _init_state(B, M, length, device)
    batch_ix = torch.arange(B, device=device)[:, None]
    pending = None  # in-flight prefetch for the next cold step
    try:
        for step in range(length):
            if step == 0 and first_logits is not None:
                logits = first_logits[:, None, :].expand(
                    B, M, first_logits.shape[-1])
            else:
                last = (state.tokens[:, :, step - 1] if step > 0 else
                        torch.zeros((B, M), dtype=torch.int32, device=device))
                logits, carry = logits_fn(carry, last, step)
            V = logits.shape[-1]
            if step < tiered.hot_steps and policy.supports_topk_at(step):
                C = policy.candidate_width(M, step)
                c_lp, c_tok, c_next = policy.step_topk(
                    logits, state.nodes, step, C)
                total = state.scores[:, :, None] + c_lp
                top_scores, top_idx = top_m(total.reshape(B, M * C), M)
                beam_idx = top_idx // C
                token = c_tok.reshape(B, M * C).gather(1, top_idx)
                new_nodes = c_next.reshape(B, M * C).gather(1, top_idx)
            else:
                if step < tiered.hot_steps:
                    lp, next_dense = policy.step(logits, state.nodes, step)
                else:
                    if pending is None:  # first cold step: no overlap
                        pending = prefetcher.prefetch(state.nodes, step)
                    gathered, lens = pending.result()
                    pending = None
                    lp, next_dense = vntk_pregathered(
                        torch.log_softmax(logits.float(), dim=-1),
                        gathered, lens, V)
                total = state.scores[:, :, None] + lp
                top_scores, top_idx = top_m(total.reshape(B, M * V), M)
                beam_idx = top_idx // V
                token = (top_idx % V).to(torch.int32)
                new_nodes = next_dense[batch_ix, beam_idx, token.long()]
            new_tokens = state.tokens[batch_ix, beam_idx]
            new_tokens[:, :, step] = token
            state = BeamState(tokens=new_tokens, scores=top_scores,
                              nodes=new_nodes.to(torch.int32))
            if tiered.hot_steps <= step + 1 < length:
                # overlap: the next step's window depends only on these nodes
                pending = prefetcher.prefetch(state.nodes, step + 1)
            if carry_gather_fn is not None and step < length - 1:
                carry = carry_gather_fn(carry, beam_idx)
    finally:
        if own_prefetcher:
            prefetcher.close()
    return state, carry
