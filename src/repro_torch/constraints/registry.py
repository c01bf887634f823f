"""Named business-constraint registry with versioned hot swap (DESIGN.md §4, §7).

Counterpart of ``repro.constraints.registry``.  Production constraint sets
are *derived* objects: a business predicate (freshness window, category
allowlist, ...) evaluated over the current item catalog.  The registry owns
that mapping:

  * ``register(name, predicate)`` — claim a slot for a named predicate.
  * ``build(catalog)``            — evaluate every predicate, build each
                                    slot's trie and pack the members into
                                    one ConstraintStore (with headroom).
  * ``swap(catalog)``             — double-buffered full refresh: rebuild
                                    every member from a new snapshot into
                                    the same capacity envelope, then flip
                                    the front buffer and bump the version.
  * ``swap_delta(delta)``         — O(churn) refresh: splice a
                                    :class:`CatalogDelta` into each slot's
                                    retained :class:`TrieSource`; equal to
                                    a full ``swap`` over the post-delta
                                    snapshot, array for array.

Headroom makes the envelope forgiving: a refreshed corpus that grew by less
than ``headroom`` still fits and the swap is **hot** (no tensor shape or
static field changes, so the retriever does not specialize again).  A
snapshot that outgrows the envelope *regrows* it by default: a store with a
larger envelope is built from the same matrices and installed as a **cold
swap** (``envelope_generation`` bumps; the retriever specializes exactly
once), while the old store serves until the flip.  ``on_overflow="raise"``
fails fast instead.

Where things live.  The store lives on ``device`` (the card by default).
The retained per-slot sources (:class:`TrieSource`) and matrices live on
the host: a host :class:`TransitionMatrix` wraps its ``FlatTrie``'s arrays
without a copy, and every swap uploads every slot straight into the back
buffer's tables (``ConstraintStore.with_members``).  Keeping them on the
card instead would save that upload but hold the five members beside the
store, about 4.1 GB for the 20M-SID catalog's five slots, and twice that
during a swap.

Threading contract (needed by :class:`~repro_torch.constraints.refresh
.AsyncRefresher`, which calls ``swap``/``swap_delta`` from its worker thread
while serving threads call ``current()``):

  * ``_lock`` guards the small shared state: ``_front``, ``_version``,
    ``_envelope_generation``, ``_names``, ``_predicates``.  It is held only
    for quick reads and writes, never across a build.
  * ``_refresh_lock`` serializes the rebuilds (``build``/``swap``/
    ``swap_delta``) and guards the retained ``_sources``/``_mats``.
  * ``current()`` returns a consistent ``(store, version)`` pair; stores are
    immutable, so a reader can keep using one after a flip.  On the card,
    the flip first synchronizes the building thread's stream, so the
    tables a reader gets are complete (:meth:`ConstraintRegistry._flip`).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.constraints.refresh import TrieSource, row_keys
from repro_torch.constraints.store import (
    _LEAF_FIELDS,
    ConstraintStore,
    EnvelopeOverflow,
)
from repro_torch.core.memory_model import measure
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.observability import MetricsRegistry
from repro_torch.reliability.faults import fire

__all__ = [
    "ItemCatalog",
    "CatalogDelta",
    "ConstraintRegistry",
    "freshness_window",
    "category_allowlist",
    "synthetic_catalog",
]

BUILD_THREADS = 4  # slot builds in flight (numpy releases the GIL in sorts)


def _check_sid_width(sids: np.ndarray, width: int, what: str) -> None:
    """SID-width mismatches must fail loudly: the byte row keys used for
    set membership null-pad the shorter side, so comparing keys of
    different widths silently matches (and deletes) the WRONG items."""
    if sids.shape[1] != width:
        raise ValueError(
            f"{what} has sid_length {sids.shape[1]}, expected {width}"
        )


@dataclasses.dataclass(frozen=True)
class ItemCatalog:
    """Immutable item-metadata snapshot predicates are evaluated against."""

    sids: np.ndarray  # (N, L) Semantic IDs of every servable item
    age_days: np.ndarray  # (N,) content age
    category: np.ndarray  # (N,) int category id

    def __post_init__(self):
        n = self.sids.shape[0]
        if self.age_days.shape != (n,) or self.category.shape != (n,):
            raise ValueError("catalog metadata must be per-item (N,) arrays")

    def select(self, mask: np.ndarray) -> "ItemCatalog":
        """Row-filtered copy (predicate masks, delta composition)."""
        return ItemCatalog(sids=self.sids[mask], age_days=self.age_days[mask],
                           category=self.category[mask])

    def apply_delta(self, delta: "CatalogDelta") -> "ItemCatalog":
        """The snapshot this catalog becomes after ``delta``.

        Removals (matched by SID) apply first, then additions are appended —
        mirroring the registry's ``swap_delta`` semantics, so
        ``reg.swap_delta(d)`` and ``reg.swap(catalog.apply_delta(d))`` land
        bit-identical stores (asserted in ``tests/test_torch_registry.py``).
        Assumes SIDs uniquely identify items (the TIGER dedup-token
        contract); metadata updates are expressed as remove + add.
        """
        out = self
        if delta.removed_sids is not None and len(delta.removed_sids):
            _check_sid_width(delta.removed_sids, self.sids.shape[1],
                             "removed_sids")
            rk = np.unique(row_keys(
                np.asarray(delta.removed_sids, dtype=np.int64)))
            keep = ~np.isin(row_keys(out.sids.astype(np.int64)), rk)
            out = out.select(keep)
        if delta.added is not None and delta.added.sids.shape[0]:
            a = delta.added
            _check_sid_width(a.sids, self.sids.shape[1], "added.sids")
            out = ItemCatalog(
                sids=np.concatenate([out.sids, a.sids]),
                age_days=np.concatenate([out.age_days, a.age_days]),
                category=np.concatenate([out.category, a.category]),
            )
        return out


@dataclasses.dataclass(frozen=True)
class CatalogDelta:
    """Incremental catalog churn: items entering and SIDs leaving.

    ``added`` carries full metadata (predicates run on the new items only);
    ``removed_sids`` is a plain (R, L) SID array — removal needs no
    metadata.  Within one delta, removals apply before additions, so a SID
    in both ends up present (with the new metadata).
    """

    added: Optional[ItemCatalog] = None
    removed_sids: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.removed_sids is not None:
            r = np.asarray(self.removed_sids)
            if r.ndim != 2:
                raise ValueError(
                    f"removed_sids must be (R, L), got shape {r.shape}"
                )
            if self.added is not None:
                _check_sid_width(r, self.added.sids.shape[1], "removed_sids")

    @property
    def is_empty(self) -> bool:
        return (
            (self.added is None or self.added.sids.shape[0] == 0)
            and (self.removed_sids is None or len(self.removed_sids) == 0)
        )

    def compose(self, later: "CatalogDelta") -> "CatalogDelta":
        """Sequential composition: ``self`` applied first, then ``later``.

        Used by the AsyncRefresher to coalesce queued deltas: removals
        union; additions that ``later`` removes again are dropped; within
        each apply, removals still precede additions, so re-added SIDs
        survive.  ``compose`` then apply-once equals apply-``self``-then-
        apply-``later`` (asserted in ``tests/test_torch_registry.py``).
        """
        rm_parts = [
            np.asarray(d.removed_sids, dtype=np.int64)
            for d in (self, later)
            if d.removed_sids is not None and len(d.removed_sids)
        ]
        removed = (np.unique(np.concatenate(rm_parts), axis=0)
                   if rm_parts else None)
        added = self.added
        if (added is not None and added.sids.shape[0]
                and later.removed_sids is not None
                and len(later.removed_sids)):
            later_rm = np.asarray(later.removed_sids)
            _check_sid_width(later_rm, added.sids.shape[1],
                             "later.removed_sids")
            rk = np.unique(row_keys(later_rm.astype(np.int64)))
            added = added.select(
                ~np.isin(row_keys(added.sids.astype(np.int64)), rk)
            )
        adds = [a for a in (added, later.added)
                if a is not None and a.sids.shape[0]]
        if len(adds) == 2:
            merged = ItemCatalog(
                sids=np.concatenate([a.sids for a in adds]),
                age_days=np.concatenate([a.age_days for a in adds]),
                category=np.concatenate([a.category for a in adds]),
            )
        else:
            merged = adds[0] if adds else None
        return CatalogDelta(added=merged, removed_sids=removed)


Predicate = Callable[[ItemCatalog], np.ndarray]  # -> (N,) bool item mask


def freshness_window(max_age_days: float) -> Predicate:
    """Items no older than ``max_age_days`` (paper §1: content freshness)."""
    return lambda cat: cat.age_days <= max_age_days


def category_allowlist(*categories: int) -> Predicate:
    """Items whose category is in the allowlist (paper §1: product category)."""
    cats = np.asarray(categories)
    return lambda cat: np.isin(cat.category, cats)


def synthetic_catalog(
    rng: np.random.Generator, n_items: int, vocab_size: int, sid_length: int,
    n_categories: int = 8, max_age_days: float = 90.0,
) -> ItemCatalog:
    """Random catalog for examples/benchmarks/CLI smoke runs."""
    return ItemCatalog(
        sids=rng.integers(0, vocab_size, size=(n_items, sid_length)),
        age_days=rng.uniform(0.0, max_age_days, size=n_items),
        category=rng.integers(0, n_categories, size=n_items),
    )


class ConstraintRegistry:
    """Slot-addressed predicate registry over a double-buffered store on
    ``device`` (the card unless the caller names one)."""

    def __init__(self, vocab_size: int, *, dense_d: int = 2,
                 headroom: float = 0.5,
                 metrics: Optional[MetricsRegistry] = None, device=None):
        self.vocab_size = vocab_size
        self.dense_d = dense_d
        self.headroom = headroom
        self.device = resolve_device(device)
        self._names: list[str] = []
        self._predicates: dict[str, Predicate] = {}
        self._front: Optional[ConstraintStore] = None
        self._version = 0
        self._envelope_generation = 0
        self._lock = threading.Lock()
        # serializes build/swap/swap_delta and guards _sources/_mats
        self._refresh_lock = threading.Lock()
        self._sources: list[TrieSource] = []
        self._mats: list[TransitionMatrix] = []  # on the host
        self.last_delta_seconds: Optional[dict] = None
        # telemetry (DESIGN.md §9), recorded on the refresh path only
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_refresh_s = self.metrics.histogram(
            "constraint_refresh_seconds",
            "wall time of one registry refresh, by kind")
        self._m_swaps = self.metrics.counter(
            "constraint_swaps_total",
            "front-buffer flips, by kind and hot/cold")
        self._m_version = self.metrics.gauge(
            "constraint_store_version", "front-buffer version")
        self._m_generation = self.metrics.gauge(
            "constraint_envelope_generation",
            "capacity-envelope generation (bumps on cold swaps)")
        self._m_states_frac = self.metrics.gauge(
            "constraint_envelope_states_used_frac",
            "largest member n_states over the envelope capacity — headroom "
            "left before the next swap goes cold")
        self._m_edges_frac = self.metrics.gauge(
            "constraint_envelope_edges_used_frac",
            "largest member n_edges over the envelope edge capacity")
        self._m_store_bytes = self.metrics.gauge(
            "constraint_store_bytes", "device bytes of the front store")
        self._m_slot_sids = self.metrics.gauge(
            "constraint_slot_sids", "live SIDs per predicate slot")
        self._m_slot_util = self.metrics.gauge(
            "constraint_slot_utilization_frac",
            "measured slab bytes over the Appendix-B u_max bound, per slot")

    def _record_store(self, store: ConstraintStore, version: int,
                      names: list[str]) -> None:
        """Publish envelope-headroom + slab-utilization gauges (refresh path)."""
        self._m_version.set(version)
        self._m_generation.set(self._envelope_generation)
        self._m_store_bytes.set(store.nbytes())
        self._m_states_frac.set(
            max(m.n_states for m in self._mats) / max(store.n_states, 1))
        self._m_edges_frac.set(
            max(m.n_edges for m in self._mats) / max(store.n_edges, 1))
        for i, name in enumerate(names):
            self._m_slot_sids.set(self._sources[i].n_sids, slot=name)
            self._m_slot_util.set(measure(self._mats[i])["utilization"],
                                  slot=name)

    # ------------------------------------------------------------------
    def register(self, name: str, predicate: Predicate) -> int:
        """Claim the next slot for ``name``; returns its constraint id."""
        with self._lock:
            if name in self._predicates:
                raise ValueError(f"predicate {name!r} already registered")
            if self._front is not None:
                raise RuntimeError(
                    "cannot register after build(): slot ids are baked into "
                    "in-flight requests"
                )
            self._names.append(name)
            self._predicates[name] = predicate
            return len(self._names) - 1

    def slot(self, name: str) -> int:
        with self._lock:
            return self._names.index(name)

    @property
    def names(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._names)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def envelope_generation(self) -> int:
        """Bumps on every cold (regrown-envelope) swap; 1 after build()."""
        with self._lock:
            return self._envelope_generation

    # ------------------------------------------------------------------
    def _eval_predicate(self, name: str, catalog: ItemCatalog) -> np.ndarray:
        mask = np.asarray(self._predicates[name](catalog), bool)
        if mask.shape != (catalog.sids.shape[0],):
            raise ValueError(f"predicate {name!r} returned a non-item mask")
        return mask

    def _build_slots(self, catalog: ItemCatalog, names: list[str]):
        """Full rebuild of every slot: (sources, host matrices), in slot
        order.  Predicates run first, in slot order; the slots' tries are
        then built in a pool of ``BUILD_THREADS`` threads, which changes
        neither the results nor their order."""
        subsets = []
        for name in names:
            mask = self._eval_predicate(name, catalog)
            if not mask.any():
                raise ValueError(
                    f"predicate {name!r} selects zero items in this snapshot"
                )
            subsets.append(catalog.sids[mask])

        def build(sids):
            src = TrieSource.from_sids(sids, self.vocab_size,
                                       dense_d=self.dense_d)
            return src, TransitionMatrix.from_flat_trie(src.flatten(),
                                                        device="cpu")

        with ThreadPoolExecutor(min(BUILD_THREADS, len(subsets))) as pool:
            built = list(pool.map(build, subsets))
        return [b[0] for b in built], [b[1] for b in built]

    def _fit_or_regrow(self, front: ConstraintStore, mats, on_overflow: str):
        """Back buffer for ``mats``: hot (same envelope) or cold (regrown)."""
        if on_overflow not in ("regrow", "raise"):
            raise ValueError("on_overflow must be 'regrow' or 'raise'")
        try:
            return front.with_members(mats), False
        except EnvelopeOverflow:
            if on_overflow == "raise":
                raise
        # cold path: a fresh envelope (with headroom) from the same
        # matrices, built here, off the serving path; the retriever
        # specializes once on the new static fields
        return ConstraintStore.from_matrices(
            mats, headroom=self.headroom, device=self.device), True

    def _flip(self, back: ConstraintStore, cold: bool) -> int:
        _settle(back)
        with self._lock:
            self._front = back
            self._version += 1
            if cold:
                self._envelope_generation += 1
            return self._version

    # ------------------------------------------------------------------
    def build(self, catalog: ItemCatalog) -> ConstraintStore:
        """Initial (version 1) store from the first catalog snapshot."""
        with self._refresh_lock:
            with self._lock:
                if not self._names:
                    raise RuntimeError("no predicates registered")
                if self._front is not None:
                    raise RuntimeError("already built; use swap() to refresh")
                names = list(self._names)
            t0 = time.monotonic()
            sources, mats = self._build_slots(catalog, names)
            store = ConstraintStore.from_matrices(
                mats, headroom=self.headroom, device=self.device)
            _settle(store)
            with self._lock:
                self._front = store
                self._version = 1
                self._envelope_generation = 1
            self._sources, self._mats = sources, mats
            self._m_refresh_s.observe(time.monotonic() - t0, kind="build")
            self._m_swaps.inc(kind="build", cold="true")
            self._record_store(store, 1, names)
            return store

    def swap(self, catalog: ItemCatalog, *,
             on_overflow: str = "regrow") -> int:
        """Full refresh of every slot from a new snapshot; returns the new
        version.

        Double-buffered: the replacement store is fully built (and checked
        against the capacity envelope) before the front pointer flips, so
        concurrent readers only ever observe a complete store.  An outgrown
        envelope regrows into a cold swap by default;
        ``on_overflow="raise"`` fails fast instead.
        """
        with self._refresh_lock:
            with self._lock:
                if self._front is None:
                    raise RuntimeError("swap() before build()")
                front = self._front
                names = list(self._names)
            t0 = time.monotonic()
            fire("refresh.build")
            sources, mats = self._build_slots(catalog, names)
            back, cold = self._fit_or_regrow(front, mats, on_overflow)
            # transactional: a failure at (or before) this point leaves the
            # front buffer, retained sources and matrices untouched
            fire("refresh.swap")
            version = self._flip(back, cold)
            self._sources, self._mats = sources, mats
            self._m_refresh_s.observe(time.monotonic() - t0, kind="snapshot")
            self._m_swaps.inc(kind="snapshot",
                              cold="true" if cold else "false")
            self._record_store(back, version, names)
            return version

    def swap_delta(self, delta: CatalogDelta, *,
                   on_overflow: str = "regrow") -> int:
        """O(churn) refresh: splice ``delta`` into every slot's retained
        :class:`TrieSource`; returns the (possibly unchanged) version.

        Predicates run on ``delta.added`` only; ``delta.removed_sids`` is
        dropped from every slot (absent SIDs are no-ops); a slot the delta
        does not touch keeps its matrix.  Equal to
        ``swap(catalog.apply_delta(delta))`` provided SIDs uniquely identify
        items and predicates are item-local and stable on unchanged items
        between refreshes.

        ``last_delta_seconds`` holds the split of the last applied delta:
        ``assemble`` (splicing and re-assembling every slot's trie on the
        host), ``upload`` (the back buffer's tables on the device, with the
        building stream synchronized) and ``flip``.
        """
        with self._refresh_lock:
            with self._lock:
                if self._front is None:
                    raise RuntimeError("swap_delta() before build()")
                front = self._front
                names = list(self._names)
            if delta.is_empty:
                self._m_swaps.inc(kind="delta", cold="noop")
                with self._lock:
                    return self._version
            t0 = time.monotonic()
            fire("refresh.build")
            staged, mats = self._stage_delta(delta, names)
            if mats is None:
                self._m_swaps.inc(kind="delta", cold="noop")
                with self._lock:
                    return self._version
            t1 = time.monotonic()
            back, cold = self._fit_or_regrow(front, mats, on_overflow)
            _settle(back)
            t2 = time.monotonic()
            # staged sources are committed only after the flip, so a fault
            # here cannot publish a half-swapped store or corrupt the
            # retained slabs
            fire("refresh.swap")
            version = self._flip(back, cold)
            for i, st in enumerate(staged):
                if st is not None:
                    self._sources[i].commit(st)
            self._mats = mats
            t3 = time.monotonic()
            self.last_delta_seconds = dict(assemble=t1 - t0, upload=t2 - t1,
                                           flip=t3 - t2)
            self._m_refresh_s.observe(t3 - t0, kind="delta")
            self._m_swaps.inc(kind="delta", cold="true" if cold else "false")
            self._record_store(back, version, names)
            return version

    def _stage_delta(self, delta: CatalogDelta, names: list[str]):
        """Stage every slot against the retained sources (``stage_delta``
        never mutates them): ``(staged, host matrices)``, a slot the delta
        leaves alone keeping its matrix; ``(staged, None)`` when no slot
        changes.  The caller validates the batch against the envelope and
        only then commits."""
        added = delta.added
        adds = []
        for name in names:
            add_sids = None
            if added is not None and added.sids.shape[0]:
                add_sids = added.sids[self._eval_predicate(name, added)]
            adds.append(add_sids)
        with ThreadPoolExecutor(min(BUILD_THREADS, len(names))) as pool:
            staged = list(pool.map(
                lambda i: self._sources[i].stage_delta(
                    adds[i], delta.removed_sids), range(len(names))))
        if all(st is None for st in staged):
            return staged, None
        return staged, [
            self._mats[i] if st is None  # untouched slot
            else TransitionMatrix.from_flat_trie(st[0], device="cpu")
            for i, st in enumerate(staged)]

    def assemble_delta(self, delta: CatalogDelta):
        """The host half of :meth:`swap_delta`, committing nothing: every
        slot's matrix with ``delta`` spliced in, on the host (``None`` when
        the delta changes no slot).  ``store.with_members`` of the result
        is the upload half; neither touches the live store or the retained
        sources."""
        with self._refresh_lock:
            with self._lock:
                if self._front is None:
                    raise RuntimeError("assemble_delta() before build()")
                names = list(self._names)
            if delta.is_empty:
                return None
            return self._stage_delta(delta, names)[1]

    def current(self) -> tuple[ConstraintStore, int]:
        """The live (store, version) pair; atomic with respect to swaps."""
        with self._lock:
            if self._front is None:
                raise RuntimeError("registry not built yet")
            return self._front, self._version

    def slot_sids(self, slot: int) -> np.ndarray:
        """Copy of the SID rows currently admissible under ``slot``:
        exactly the retained sorted slab the slot's trie was built from (the
        ground truth served SIDs are checked against)."""
        with self._refresh_lock:
            if not self._sources:
                raise RuntimeError("registry not built yet")
            return np.array(self._sources[slot].sids, copy=True)


def _settle(store: ConstraintStore) -> None:
    """Make a freshly built store safe to hand to another stream.

    On the card the store's tables were written on the building thread's
    stream (the refresher's own).  That stream is synchronized here, before
    the flip, so a reader on any stream sees complete tables.  The tables
    then cross to the serving stream (the device's default one): each is
    ``record_stream``-ed there, so when the last reference drops, the
    allocator does not hand its memory to the building stream before the
    serving stream's work queued up to then has finished.  (The engine
    also drops a store only between batches, after a retrieve's ``.cpu()``
    has waited for every kernel that read it.)
    """
    if store.device.type != "cuda":
        return
    stream = torch.cuda.current_stream(store.device)
    stream.synchronize()
    serving = torch.cuda.default_stream(store.device)
    if stream != serving:
        for f in _LEAF_FIELDS:
            getattr(store, f).record_stream(serving)
