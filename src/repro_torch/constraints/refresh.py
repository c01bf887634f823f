"""Incremental catalog refresh: delta-aware trie rebuilds + async hot swap.

Counterpart of ``repro.constraints.refresh`` (DESIGN.md §7).  The paper's
motivating business constraint is *content freshness* (§1): the restricted
item set changes all the time, and a from-scratch
:func:`~repro_torch.core.trie.build_flat_trie` per refresh scales with the
catalog, not with the churn.

  * :class:`TrieSource` keeps the sorted SID slab of the build (big-endian in
    the narrowest token dtype, so its byte row keys are a zero-copy view)
    and a packed per-row ``new_prefix`` bitfield across refreshes.
    ``apply_delta(add_sids, remove_sids)`` merges the sorted delta into the
    slab (O(Δ log Δ) to sort it, O(Δ log N) to locate it, O(N) to splice)
    and re-assembles the CSR with a lean pass that re-derives nothing the
    slab already knows.  The result is array for array equal to
    ``build_flat_trie`` over the post-delta set, and to the reference's
    ``TrieSource``.  It is numpy, as the port's trie construction is.

  * :class:`AsyncRefresher` runs predicate evaluation, trie rebuilds and
    the back buffer's upload on a worker thread, and the registry flips its
    front buffer under a lock; serving engines pick the new store up at
    their next batch boundary.  Submissions return futures that resolve to
    the installed registry version; build failures (a CUDA out-of-memory
    error included) propagate through the future while the old store keeps
    serving.  Pending work is coalesced (a newer snapshot supersedes what
    was queued, consecutive deltas compose); without coalescing,
    submitters block once ``max_pending`` ops are queued (backpressure).

    On the card the worker sets its device (the current device is per
    thread in PyTorch) and builds the back buffer on a CUDA stream of its
    own, so the upload overlaps the serving thread's retrieves; the
    registry synchronizes that stream before its flip
    (``ConstraintRegistry._flip``), so a reader never sees a half-copied
    store.

Row-key trick: a row of non-negative integer tokens compares
lexicographically exactly like its big-endian byte concatenation, so each
SID row becomes one fixed-width bytes scalar and sorted-set membership and
merge positions are plain ``np.searchsorted`` calls.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from repro_torch.core.trie import (
    FlatTrie,
    check_index_capacity,
    sorted_unique_sids,
)
from repro_torch.observability import MetricsRegistry
from repro_torch.reliability.retry import RetryPolicy

__all__ = ["TrieSource", "AsyncRefresher", "row_keys"]

logger = logging.getLogger("repro_torch.constraints.refresh")


# ---------------------------------------------------------------------------
# sorted-slab maintenance
# ---------------------------------------------------------------------------
def row_keys(s: np.ndarray) -> np.ndarray:
    """(N, L) non-negative integer rows -> (N,) big-endian byte keys.

    Keys of arrays with the same integer width are mutually comparable;
    the TrieSource keeps its slab and every delta in ONE dtype so its
    searchsorted calls always compare like with like.
    """
    w = s.dtype.itemsize
    be = np.ascontiguousarray(s, dtype=s.dtype.newbyteorder(">"))
    return be.view(f"S{w * s.shape[1]}").ravel()


def _slab_dtype(vocab_size: int) -> np.dtype:
    """Narrowest BIG-ENDIAN integer dtype holding every token id.

    The slab is the array every refresh splices, so its width is the
    dominant delta cost; token ids are bounded by the vocab (2k-8k in the
    paper's settings), not by state counts.  Big-endian storage makes the
    row-key array a zero-copy *view* of the slab (see :func:`row_keys`) —
    no second array to keep in sync or splice.  Strict inequality keeps
    ``token + 1`` (the virtual-id convention) overflow-free even before
    the assembly-side upcast.
    """
    for dt in (np.int16, np.int32):
        if vocab_size < np.iinfo(dt).max:
            return np.dtype(dt).newbyteorder(">")
    return np.dtype(np.int64).newbyteorder(">")


def _normalize_delta(sids, vocab_size: int, L: int, dtype,
                     what: str) -> np.ndarray:
    """Validated, lexsorted, deduplicated (D, L) delta rows in slab dtype."""
    if sids is None:
        return np.zeros((0, L), dtype=dtype)
    sids = np.asarray(sids)
    if sids.ndim != 2 or sids.shape[1] != L:
        raise ValueError(
            f"{what} must be (D, {L}), got shape {sids.shape}"
        )
    if sids.shape[0] == 0:
        return np.zeros((0, L), dtype=dtype)
    if sids.min() < 0 or sids.max() >= vocab_size:
        raise ValueError(f"{what}: token ids out of range [0, vocab_size)")
    return sorted_unique_sids(sids.astype(np.int64, copy=False)).astype(dtype)


def _splice(arr: np.ndarray, keep: Optional[np.ndarray],
            ins_pos: np.ndarray, ins_rows: np.ndarray) -> np.ndarray:
    """``arr[keep]`` with ``ins_rows`` inserted before positions ``ins_pos``.

    ``ins_pos`` is sorted and indexes the post-``keep`` array (np.insert
    semantics), but this is ~3x faster than ``np.delete`` + ``np.insert``:
    one boolean compress plus one masked scatter, no index sorting, no
    second full copy.  Always returns a fresh array (the caller's
    transaction commit).
    """
    mid = arr[keep] if keep is not None else arr
    k = ins_pos.shape[0]
    if k == 0:
        return mid if keep is not None else mid.copy()
    n_final = mid.shape[0] + k
    out = np.empty((n_final,) + arr.shape[1:], dtype=arr.dtype)
    ins_final = ins_pos + np.arange(k)
    mask = np.ones(n_final, dtype=bool)
    mask[ins_final] = False
    out[ins_final] = ins_rows
    out[mask] = mid
    return out


def _npx_dtype(L: int) -> np.dtype:
    """Dtype of the packed new-prefix bitfield (one integer per slab row)."""
    for bits, dt in ((8, np.uint8), (16, np.uint16), (32, np.uint32),
                     (64, np.uint64)):
        if L <= bits:
            return np.dtype(dt)
    raise ValueError(f"sid_length {L} > 64 is unsupported by TrieSource")


def _prefix_bits(s: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Packed ``new_prefix`` rows for slab positions ``idx``.

    Bit ``l`` of entry ``i`` is True iff row ``idx[i]`` starts a new
    (l+1)-prefix — i.e. it differs from its predecessor in some column
    ``<= l``.  Packing the per-level booleans into one integer per row
    keeps the refresh splice 1-D (the fast path) and L-times smaller.
    """
    L = s.shape[1]
    dt = _npx_dtype(L)
    out = np.empty(idx.shape[0], dtype=dt)
    interior = idx > 0
    out[~interior] = dt.type((1 << L) - 1)  # row 0 starts every prefix
    if interior.any():
        d = s[idx[interior]] != s[idx[interior] - 1]
        acc = np.logical_or.accumulate(d, axis=1)
        w = np.uint64(1) << np.arange(L, dtype=np.uint64)
        out[interior] = (acc * w).sum(axis=1).astype(dt)
    return out


def _assemble(s: np.ndarray, new_prefix: np.ndarray, vocab_size: int,
              dense_d: int, index_dtype) -> FlatTrie:
    """Lean CSR assembly from a sorted slab and its ``new_prefix`` table.

    Produces output bit-identical to :func:`~repro_torch.core.trie.build_flat_trie`
    but skips everything the retained slab makes redundant: within-level
    prefix ranks are ``arange`` (rows are sorted, so ranks are positional),
    parent ranks come from one ``searchsorted`` per level instead of a full
    (N, L) cumsum, and the per-state edge runs are written directly in CSR
    order (the stable argsort of ``build_flat_trie`` is the identity here
    by construction).
    """
    n, L = s.shape
    # Rows are unique, so every row starts a new L-prefix: the leaf level's
    # positions are all of [0, n) — no scan needed.
    pos = [np.nonzero(new_prefix & new_prefix.dtype.type(1 << lvl))[0]
           for lvl in range(L - 1)]
    pos.append(np.arange(n, dtype=np.int64))
    npl = np.array([p.shape[0] for p in pos], dtype=np.int64)

    level_offsets = np.zeros(L + 2, dtype=np.int64)
    level_offsets[0] = 1  # root
    level_offsets[1] = 2
    for lvl in range(1, L + 1):
        level_offsets[lvl + 1] = level_offsets[lvl] + npl[lvl - 1]
    d_eff = min(dense_d, L)
    shift = int(level_offsets[d_eff]) - 1

    level_bmax = np.zeros(L, dtype=np.int64)
    counts_lvl = []  # per-source-state child counts, levels 0..L-1
    tok_lvl = []
    for lvl in range(L):
        tok_lvl.append(s[pos[lvl], lvl])
        if lvl == 0:
            cnt = np.array([npl[0]], dtype=np.int64)  # the root's children
        else:
            # pos[lvl-1] ⊆ pos[lvl] (new_prefix accumulates along the row),
            # so the children of parent j are the pos[lvl] entries falling
            # in [pos[lvl-1][j], pos[lvl-1][j+1]) — probe the SMALL parent
            # array into the big child array instead of ranking every child
            cnt = np.diff(np.searchsorted(pos[lvl],
                                          np.append(pos[lvl - 1], n)))
        counts_lvl.append(cnt)
        if cnt.size:
            level_bmax[lvl] = int(cnt.max())

    n_states = int(level_offsets[-1]) - shift
    n_edges = int(npl[d_eff:].sum())
    bmax = int(level_bmax.max())
    pad = -bmax % 128 + bmax + 128
    check_index_capacity(index_dtype, n_states=n_states,
                         n_edge_rows=n_edges + pad, vocab_size=vocab_size)

    # Row pointers: [sink] + non-leaf retained levels, then leaves (0 edges).
    rp = np.zeros(n_states + 1, dtype=np.int64)
    counts_full = np.concatenate(
        [np.zeros(1, dtype=np.int64)] + counts_lvl[d_eff:]
    )
    m = counts_full.shape[0]
    np.cumsum(counts_full, out=rp[1 : 1 + m])
    rp[1 + m :] = rp[m]

    # Stacked edges, written level-contiguous: within a level rows are in
    # slab order == (parent ascending, token ascending), matching the
    # lexsort + stable-by-source ordering of ``build_flat_trie``.
    edges = np.zeros((n_edges + pad, 2), dtype=index_dtype)
    o = 0
    for lvl in range(d_eff, L):
        k = int(npl[lvl])
        base = int(level_offsets[lvl + 1]) - shift
        edges[o : o + k, 0] = tok_lvl[lvl]
        edges[o : o + k, 1] = np.arange(base, base + k)
        o += k

    new_offsets = np.maximum(level_offsets - shift, 1)
    new_offsets[:d_eff] = 1
    trie = FlatTrie(
        vocab_size=vocab_size,
        sid_length=L,
        n_constraints=n,
        row_pointers=rp.astype(index_dtype),
        edges=edges,
        n_states=n_states,
        n_edges=n_edges,
        level_offsets=new_offsets,
        level_bmax=level_bmax,
        dense_d=dense_d,
    )

    # Dense tables: scatter set bits straight into the packed words —
    # bit-identical to pack_bits (same little-endian convention: bit
    # ``y & 7`` of word ``y >> 3``) without materializing the (V, V) bool
    # mask or its five-pass packing reduction.
    if dense_d >= 1:
        l0_states = np.zeros(vocab_size, dtype=index_dtype)
        y1 = np.asarray(tok_lvl[0], dtype=np.int64)  # upcast: narrow slabs
        packed0 = np.zeros((vocab_size + 7) // 8, dtype=np.uint8)
        np.bitwise_or.at(packed0, y1 >> 3,
                         np.uint8(1) << (y1 & 7).astype(np.uint8))
        if dense_d == 1 or L < 2:
            l0_states[y1] = (level_offsets[1] + np.arange(npl[0])) - shift
        else:
            l0_states[y1] = y1 + 1  # virtual ids (paper Appendix E)
        trie.l0_mask_packed = packed0
        trie.l0_states = l0_states
    if dense_d >= 2 and L >= 2:
        l1_states = np.zeros((vocab_size, vocab_size), dtype=index_dtype)
        y1 = np.asarray(s[pos[1], 0], dtype=np.int64)
        y2 = np.asarray(tok_lvl[1], dtype=np.int64)
        packed1 = np.zeros((vocab_size, (vocab_size + 7) // 8),
                           dtype=np.uint8)
        np.bitwise_or.at(packed1, (y1, y2 >> 3),
                         np.uint8(1) << (y2 & 7).astype(np.uint8))
        l1_states[y1, y2] = (level_offsets[2] + np.arange(npl[1])) - shift
        trie.l1_mask_packed = packed1
        trie.l1_states = l1_states
    return trie


class TrieSource:
    """Retained build state for O(churn) re-flattening (DESIGN.md §7).

    Holds the lexsorted deduplicated SID slab (big-endian, so the row-key
    array is a free view) and the per-row ``new_prefix`` table.
    ``flatten()`` assembles the current :class:`FlatTrie`; ``apply_delta``
    splices a churn delta into the slab and re-assembles.  Both are
    bit-identical to ``build_flat_trie(current_sids, ...)``.

    Not thread-safe: callers (the registry's refresh path) serialize access.
    """

    def __init__(self, slab: np.ndarray, new_prefix: np.ndarray,
                 vocab_size: int, dense_d: int, index_dtype):
        self._slab = slab
        self._new_prefix = new_prefix
        self.vocab_size = vocab_size
        self.dense_d = dense_d
        self.index_dtype = index_dtype

    def _keys(self) -> np.ndarray:
        """Row keys as a zero-copy view of the big-endian slab."""
        return row_keys(self._slab)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_sids(cls, sids: np.ndarray, vocab_size: int, *, dense_d: int = 2,
                  index_dtype=np.int32) -> "TrieSource":
        sids = np.asarray(sids)
        if sids.ndim != 2 or sids.size == 0:
            raise ValueError(f"sids must be non-empty (N, L), got {sids.shape}")
        if sids.min() < 0 or sids.max() >= vocab_size:
            raise ValueError("token ids out of range [0, vocab_size)")
        s = sorted_unique_sids(sids.astype(np.int64, copy=False))
        s = s.astype(_slab_dtype(vocab_size))
        return cls(s, _prefix_bits(s, np.arange(s.shape[0])),
                   vocab_size, dense_d, index_dtype)

    def clone(self) -> "TrieSource":
        """Deep copy (benchmarks re-apply deltas to a fresh source)."""
        return TrieSource(self._slab.copy(), self._new_prefix.copy(),
                          self.vocab_size, self.dense_d, self.index_dtype)

    # -- introspection ------------------------------------------------------
    @property
    def n_sids(self) -> int:
        return self._slab.shape[0]

    @property
    def sid_length(self) -> int:
        return self._slab.shape[1]

    @property
    def sids(self) -> np.ndarray:
        """The current SID set (sorted, deduplicated; read-only view)."""
        v = self._slab.view()
        v.flags.writeable = False
        return v

    def __contains__(self, sid) -> bool:
        k = row_keys(np.asarray(sid, dtype=self._slab.dtype).reshape(1, -1))
        keys = self._keys()
        p = int(np.searchsorted(keys, k[0]))
        return p < keys.shape[0] and keys[p] == k[0]

    # -- flattening ---------------------------------------------------------
    def flatten(self) -> FlatTrie:
        """The current slab's FlatTrie (== from-scratch build, bit for bit)."""
        return _assemble(self._slab, self._new_prefix, self.vocab_size,
                         self.dense_d, self.index_dtype)

    def apply_delta(self, add_sids=None,
                    remove_sids=None) -> Optional[FlatTrie]:
        """Splice a churn delta into the slab and re-assemble the trie.

        Removals apply first, then additions (a SID present in both ends up
        in the set).  Removing an absent SID and re-adding a present one are
        no-ops.  Returns ``None`` when the delta removes and inserts nothing
        (callers reuse their previous matrix); otherwise returns a FlatTrie
        bit-identical to ``build_flat_trie`` over the post-delta set — note
        a remove-then-readd of the same SID does splice the slab and returns
        a (value-identical) rebuilt trie.  The update is transactional: on
        any error the retained state is untouched.
        """
        staged = self.stage_delta(add_sids, remove_sids)
        if staged is None:
            return None
        self.commit(staged)
        return staged[0]

    def stage_delta(self, add_sids=None, remove_sids=None):
        """``apply_delta`` without the commit: returns an opaque staged
        tuple (trie first) or ``None`` for a no-op.

        The registry stages every slot of a multi-slot refresh against the
        ORIGINAL sources, validates the whole batch against the capacity
        envelope, and only then :meth:`commit`\\ s each slot — transactional
        across slots with zero slab copies (splices build fresh arrays, so
        the retained state is never touched until commit).
        """
        L = self.sid_length
        dt = self._slab.dtype
        rm = _normalize_delta(remove_sids, self.vocab_size, L, dt,
                              "remove_sids")
        ad = _normalize_delta(add_sids, self.vocab_size, L, dt, "add_sids")
        slab = self._slab
        keys = self._keys()
        n = slab.shape[0]

        removed_idx = np.zeros(0, dtype=np.int64)
        if rm.shape[0]:
            rk = row_keys(rm)
            p = np.searchsorted(keys, rk)
            pc = np.minimum(p, n - 1)
            hit = (p < n) & (keys[pc] == rk)
            removed_idx = p[hit]
        if removed_idx.shape[0]:
            keep = np.ones(n, dtype=bool)
            keep[removed_idx] = False
            # mid-coordinate position of the first survivor after each
            # removed run (its predecessor changed => new_prefix recompute)
            kc = np.cumsum(keep)
            succ_mid = np.unique(kc[removed_idx])
            n_mid = n - removed_idx.shape[0]
        else:
            keep = None
            succ_mid = np.zeros(0, dtype=np.int64)
            n_mid = n

        # Insert positions are searched against the ORIGINAL keys and then
        # shifted down by the removals before them — no post-removal key
        # array is ever materialized.  An add that matches a REMOVED row is
        # not a duplicate (remove-then-readd re-splices, see above).
        ins_mid = np.zeros(0, dtype=np.int64)
        if ad.shape[0]:
            ak = row_keys(ad)
            p = np.searchsorted(keys, ak)
            pc = np.minimum(p, n - 1)
            present = (p < n) & (keys[pc] == ak)
            dup = present.copy()
            if keep is not None:
                dup[present] = keep[p[present]]
            ad, p = ad[~dup], p[~dup]
            ins_mid = (p - np.searchsorted(removed_idx, p)
                       if removed_idx.shape[0] else p)
        if keep is None and not ins_mid.shape[0]:
            return None  # no effective churn: slab unchanged

        if n_mid + ins_mid.shape[0] == 0:
            raise ValueError("delta removes every SID; constraint set must "
                             "be non-empty")

        new_slab = _splice(slab, keep, ins_mid, ad)

        # new_prefix: splice rows, then recompute exactly the rows whose
        # (predecessor, row) pair changed — inserted rows, their successors,
        # and the survivors right after removed runs.  Everything else keeps
        # its value (it depends only on its unchanged predecessor pair).
        npx = _splice(self._new_prefix, keep, ins_mid,
                      np.zeros(ins_mid.shape[0], dtype=self._new_prefix.dtype))
        if ins_mid.shape[0]:
            ins_final = ins_mid + np.arange(ins_mid.shape[0])
            succ_final = succ_mid + np.searchsorted(ins_mid, succ_mid,
                                                    side="right")
            affected = np.concatenate([ins_final, ins_final + 1, succ_final])
        else:
            affected = succ_mid
        n_new = new_slab.shape[0]
        affected = np.unique(affected[affected < n_new])
        npx[affected] = _prefix_bits(new_slab, affected)

        trie = _assemble(new_slab, npx, self.vocab_size, self.dense_d,
                         self.index_dtype)
        return trie, new_slab, npx

    def commit(self, staged) -> None:
        """Install state staged by :meth:`stage_delta`."""
        _, self._slab, self._new_prefix = staged


# ---------------------------------------------------------------------------
# async hot-swap pipeline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Op:
    kind: str  # "snapshot" | "delta"
    payload: object
    futures: list
    t_submit: float = 0.0  # time.monotonic() at enqueue (queue-wait metric)


class AsyncRefresher:
    """Background refresh worker over a :class:`ConstraintRegistry`.

    ``swap_async(catalog)`` / ``apply_delta_async(delta)`` enqueue a rebuild
    and return a ``Future`` resolving to the installed registry version.
    Predicate evaluation, trie construction and envelope checks run on the
    worker thread; the registry's front-buffer flip is lock-atomic, so
    serving engines observe the new store at their next batch boundary with
    no new specialization of the retrieve step (or exactly one, for an
    envelope-regrowth cold swap — the registry decides, see
    ``ConstraintRegistry.swap``).

    Coalescing (default on): a full snapshot supersedes everything queued
    before it (those submitters' futures resolve with the snapshot's
    version — their state is subsumed by the newer authoritative snapshot),
    and consecutive deltas compose via ``CatalogDelta.compose``.  The queue
    therefore never exceeds two ops (one snapshot + one trailing delta).
    With ``coalesce=False`` every op is preserved and submitters block once
    ``max_pending`` ops are queued — classic backpressure.

    A failing rebuild (predicate error, injected fault, transient allocator
    pressure, ...) is **retried with capped exponential backoff** under
    ``retry`` (a :class:`~repro_torch.reliability.RetryPolicy`; attempts/backoff
    land in ``refresh_retries_total``).  Only a *terminal* failure — every
    attempt exhausted, or a non-retryable error — sets the exception on the
    op's futures (including any futures coalesced into it: nothing is
    silently dropped) and the worker moves on; the registry front buffer is
    untouched either way and serving continues on the previous version.
    The whole retry loop runs inside the worker's busy window, so
    ``drain(timeout=)`` cannot return while an op is still being retried.

    **On the card** the worker thread sets the registry's device and runs
    every op on a CUDA stream of its own: the back buffer's uploads and
    copies overlap the serving thread's retrieves, and the registry
    synchronizes the worker's stream before it flips (see
    ``ConstraintRegistry._flip``).  A CUDA out-of-memory error while the
    back buffer is built is a build failure like any other: the future
    gets the exception and the old store keeps serving.

    **Staleness**: from the first submission the front buffer is behind
    until the worker catches up; :meth:`staleness_seconds` reports how long
    the oldest unapplied submission has been waiting (0 when caught up) and
    publishes the ``constraint_staleness_seconds`` gauge — the serve-stale
    rung of the degradation ladder made observable (DESIGN.md §13).  A
    terminal failure leaves the clock running: serving is genuinely behind
    the authoritative catalog until a later op succeeds.
    """

    def __init__(self, registry, *, coalesce: bool = True,
                 max_pending: int = 4,
                 metrics: Optional[MetricsRegistry] = None,
                 retry: Optional[RetryPolicy] = None):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self._registry = registry
        self._coalesce = coalesce
        self._max_pending = max_pending
        self._retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay_s=0.01, max_delay_s=0.25)
        self._cond = threading.Condition()
        self._queue: list[_Op] = []
        self._busy = False
        self._closed = False
        self._t_behind_since: Optional[float] = None
        self.coalesced = 0  # ops merged into a newer submission
        self.applied = 0  # ops that installed a version
        self.failed = 0  # ops whose build raised
        self.last_error: Optional[BaseException] = None
        # telemetry: default to the registry's MetricsRegistry so refresher
        # and registry metrics land in one scrape/snapshot; the legacy int
        # attributes above stay authoritative for existing callers
        if metrics is None:
            metrics = getattr(registry, "metrics", None)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_ops = self.metrics.counter(
            "refresh_ops_total",
            "async refresh ops, by kind and outcome "
            "(applied/failed/coalesced)")
        self._m_apply_s = self.metrics.histogram(
            "refresh_apply_seconds",
            "worker-side wall time of one refresh op (build + flip), by kind")
        self._m_queue_s = self.metrics.histogram(
            "refresh_queue_seconds",
            "submit→worker-pickup wait of applied/failed ops")
        self._m_depth = self.metrics.gauge(
            "refresh_queue_depth", "ops waiting in the refresher queue")
        self._m_backpressure = self.metrics.counter(
            "refresh_backpressure_waits_total",
            "submitter blocks because the queue was full (coalesce off)")
        self._m_retries = self.metrics.counter(
            "refresh_retries_total",
            "refresh attempts retried after a transient failure, by kind")
        self._m_staleness = self.metrics.gauge(
            "constraint_staleness_seconds",
            "how long the oldest unapplied catalog submission has waited; "
            "0 when the front store is caught up (DESIGN.md §13)")
        # the registry's device with its index: "cuda" alone means the
        # submitting thread's current device, not the worker's
        dev = getattr(registry, "device", None)
        if dev is not None and dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="constraint-refresh"
        )
        self._thread.start()

    # -- submission ---------------------------------------------------------
    def swap_async(self, catalog) -> Future:
        """Full-snapshot refresh of every slot; future -> new version."""
        return self._submit("snapshot", catalog)

    def apply_delta_async(self, delta) -> Future:
        """O(churn) delta refresh of every slot; future -> new version."""
        return self._submit("delta", delta)

    def _submit(self, kind: str, payload) -> Future:
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncRefresher is closed")
            now = time.monotonic()
            while True:
                if self._coalesce and kind == "snapshot":
                    # authoritative full state: subsume everything queued
                    carried = [f for op in self._queue for f in op.futures]
                    n = len(self._queue)
                    self.coalesced += n
                    if n:
                        self._m_ops.inc(n, kind=kind, outcome="coalesced")
                    self._queue = [_Op(kind, payload, carried + [fut], now)]
                    break
                if (self._coalesce and kind == "delta" and self._queue
                        and self._queue[-1].kind == "delta"):
                    last = self._queue[-1]
                    last.payload = last.payload.compose(payload)
                    last.futures.append(fut)
                    self.coalesced += 1
                    self._m_ops.inc(kind=kind, outcome="coalesced")
                    break
                if len(self._queue) < self._max_pending:
                    self._queue.append(_Op(kind, payload, [fut], now))
                    break
                self._m_backpressure.inc(kind=kind)
                self._cond.wait()  # backpressure: queue full, can't coalesce
                if self._closed:
                    raise RuntimeError("AsyncRefresher is closed")
            if self._t_behind_since is None:
                self._t_behind_since = now  # front store now behind
            self._m_depth.set(len(self._queue))
            self._cond.notify_all()
        return fut

    def staleness_seconds(self, now: Optional[float] = None) -> float:
        """Age of the oldest submission the front store does not reflect
        (0.0 when caught up).  Publishes ``constraint_staleness_seconds``."""
        now = time.monotonic() if now is None else now
        with self._cond:
            t = self._t_behind_since
        s = 0.0 if t is None else max(now - t, 0.0)
        self._m_staleness.set(s)
        return s

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty and the worker is idle.

        ``_busy`` spans the worker's *entire* retry loop (backoff sleeps
        included), so a True return means no refresh work — queued,
        running, or mid-retry — remains in flight.
        """
        with self._cond:
            return self._cond.wait_for(
                lambda: not self._queue and not self._busy, timeout=timeout
            )

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting work, finish what is queued, join the worker."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    def __enter__(self) -> "AsyncRefresher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker -------------------------------------------------------------
    def _worker_stream(self):
        """The worker's device and stream context: on the card, the
        registry's device (set here, as the current device is per thread)
        and a fresh stream, so builds never queue behind serving work."""
        dev = self._device
        if dev is None or dev.type != "cuda":
            return contextlib.nullcontext()
        torch.cuda.set_device(dev)
        return torch.cuda.stream(torch.cuda.Stream(dev))

    def _worker(self) -> None:
        with self._worker_stream():
            self._serve_ops()

    def _serve_ops(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                op = self._queue.pop(0)
                self._busy = True
                self._m_depth.set(len(self._queue))
                self._cond.notify_all()  # wake backpressure waiters
            # Transition futures to RUNNING; a future the caller already
            # cancelled is dropped here — setting a result on it would
            # raise InvalidStateError and kill the worker thread.
            live = [f for f in op.futures if f.set_running_or_notify_cancel()]
            t0 = time.monotonic()
            self._m_queue_s.observe(max(t0 - op.t_submit, 0.0), kind=op.kind)

            def do_apply(op=op):
                if op.kind == "snapshot":
                    return self._registry.swap(op.payload)
                return self._registry.swap_delta(op.payload)

            def on_retry(attempt, e, op=op):
                # a failed attempt's frames may hold a half-built back
                # buffer on the device: drop their locals
                traceback.clear_frames(e.__traceback__)
                self._m_retries.inc(kind=op.kind)
                logger.warning(
                    "refresh %s attempt %d failed; retrying in %.3fs: %s",
                    op.kind, attempt + 1, self._retry.delay_s(attempt), e)

            applied_ok = False
            try:
                # retries (and their backoff sleeps) run inside the busy
                # window, so drain() cannot observe an "empty" refresher
                # that still has this op in flight
                version = self._retry.call(do_apply, on_retry=on_retry)
            except BaseException as e:  # propagate, never kill serving
                self.failed += 1
                self.last_error = e
                self._m_ops.inc(kind=op.kind, outcome="failed")
                logger.error(
                    "refresh %s failed terminally after %d attempt(s) "
                    "(serving continues on the previous store): %s",
                    op.kind, self._retry.max_attempts, e, exc_info=e,
                )
                traceback.clear_frames(e.__traceback__)  # as in on_retry
                for f in live:
                    f.set_exception(e)
            else:
                applied_ok = True
                self.applied += 1
                self._m_ops.inc(kind=op.kind, outcome="applied")
                self._m_apply_s.observe(time.monotonic() - t0, kind=op.kind)
                logger.debug("refresh %s applied: version %s", op.kind,
                             version)
                for f in live:
                    f.set_result(version)
            finally:
                with self._cond:
                    self._busy = False
                    if applied_ok:
                        # caught up to this op; still behind iff more work
                        # is queued.  A terminal failure keeps the clock
                        # running — the catalog state was never applied.
                        self._t_behind_since = (
                            self._queue[0].t_submit if self._queue else None)
                    self._cond.notify_all()
