"""Port registry and incremental refresh against the JAX reference (§7).

Inputs come from a seed with numpy and go through both packages:
  1. the port's ``TrieSource.flatten``/``apply_delta`` equal the reference's
     ``TrieSource`` and the port's ``build_flat_trie`` over the post-delta
     set, array for array and dtype for dtype, under seeded churn;
  2. the port's ``ConstraintRegistry`` builds, swaps and delta-swaps stores
     equal to the reference registry's in every table and static field,
     regrows its envelope as a cold swap, and keeps its front store and
     retained sources when a refresh fails;
  3. ``AsyncRefresher`` applies, propagates errors, coalesces, applies
     backpressure and survives a cancelled future.

Tests with a counterpart in ``tests/test_refresh.py`` keep its name.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.constraints import CatalogDelta as JaxCatalogDelta
from repro.constraints import ConstraintRegistry as JaxConstraintRegistry
from repro.constraints import ItemCatalog as JaxItemCatalog
from repro.constraints import TrieSource as JaxTrieSource
from repro.constraints import category_allowlist as jax_category_allowlist
from repro.constraints import freshness_window as jax_freshness_window
from repro_torch.constraints import (
    AsyncRefresher,
    CatalogDelta,
    ConstraintRegistry,
    EnvelopeOverflow,
    ItemCatalog,
    TrieSource,
    category_allowlist,
    freshness_window,
)
from repro_torch.constraints.store import _LEAF_FIELDS
from repro_torch.core import NEG_INF
from repro_torch.core.beam_search import beam_search
from repro_torch.core.trie import build_flat_trie
from repro_torch.decoding import DecodePolicy
from repro_torch.reliability import FaultInjector, FaultSpec, active_injector

from conftest import make_sids

V, L = 16, 4
STATIC = ("vocab_size", "sid_length", "dense_d", "level_bmax", "n_states",
          "n_edges", "num_sets")
TRIE_ARRAYS = ("row_pointers", "edges", "level_offsets", "level_bmax")
DENSE_ARRAYS = ("l0_mask_packed", "l0_states", "l1_mask_packed", "l1_states")


def assert_tries_equal(a, b):
    """Array-for-array, dtype-for-dtype FlatTrie equality (either package)."""
    assert a.n_states == b.n_states and a.n_edges == b.n_edges
    assert a.n_constraints == b.n_constraints
    for f in TRIE_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(x, y, err_msg=f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
    for f in DENSE_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
            assert x.dtype == y.dtype, (f, x.dtype, y.dtype)


def assert_stores_equal(got, want):
    """Port store ``got`` equals ``want`` (either package), table for table
    and static field for static field."""
    for f in _LEAF_FIELDS:
        g = getattr(got, f).cpu().numpy()
        w = getattr(want, f)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in STATIC:
        assert getattr(got, f) == getattr(want, f), f


# ---------------------------------------------------------------------------
# TrieSource: delta == from-scratch == the reference, array for array
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dense_d", [0, 1, 2])
@pytest.mark.parametrize("length", [1, 2, 4, 6])
def test_flatten_matches_builder(rng, dense_d, length):
    sids = make_sids(rng, 200, V, length, clustered=True)
    got = TrieSource.from_sids(sids, V, dense_d=dense_d).flatten()
    assert_tries_equal(got, build_flat_trie(sids, V, dense_d=dense_d))
    assert_tries_equal(
        got, JaxTrieSource.from_sids(sids, V, dense_d=dense_d).flatten())


@pytest.mark.parametrize("dense_d", [0, 1, 2])
@pytest.mark.parametrize("seed", range(4))
def test_apply_delta_bit_identical_under_churn(seed, dense_d):
    """Seeded add/remove churn over five rounds: every delta rebuild equals
    the port's from-scratch build and the reference source's delta."""
    rng = np.random.default_rng(seed)
    vocab = int(rng.integers(5, 30))
    length = int(rng.integers(1, 6))
    sids = rng.integers(0, vocab, size=(int(rng.integers(5, 250)), length))
    src = TrieSource.from_sids(sids, vocab, dense_d=dense_d)
    ref = JaxTrieSource.from_sids(sids, vocab, dense_d=dense_d)
    cur = {tuple(r) for r in sids.astype(np.int64)}
    for _ in range(5):
        n_add, n_rm = int(rng.integers(0, 40)), int(rng.integers(0, 40))
        add = rng.integers(0, vocab, size=(n_add, length)) if n_add else None
        rm = None
        if n_rm and cur:
            pool = np.array(sorted(cur), np.int64)
            rm = np.concatenate([
                pool[rng.integers(0, pool.shape[0], size=n_rm // 2 + 1)],
                rng.integers(0, vocab, size=(n_rm // 2, length)),
            ])  # present rows and (mostly absent) random rows
        rm_set = {tuple(r) for r in rm} if rm is not None else set()
        add_set = ({tuple(r) for r in add.astype(np.int64)}
                   if add is not None else set())
        new = (cur - rm_set) | add_set
        if not new:
            with pytest.raises(ValueError, match="non-empty"):
                src.apply_delta(add, rm)
            continue
        ft, want_ft = src.apply_delta(add, rm), ref.apply_delta(add, rm)
        assert (ft is None) == (want_ft is None)
        want = np.array(sorted(new), np.int64)
        if ft is not None:
            assert_tries_equal(ft, build_flat_trie(want, vocab,
                                                   dense_d=dense_d))
            assert_tries_equal(ft, want_ft)
        np.testing.assert_array_equal(np.asarray(src.sids, np.int64), want)
        assert src.sids.dtype == ref.sids.dtype
        cur = new


def test_apply_delta_noop_and_semantics(rng):
    sids = make_sids(rng, 80, V, L, clustered=True)
    src = TrieSource.from_sids(sids, V)
    present = np.asarray(src.sids, dtype=np.int64)
    # removing absent rows + re-adding present rows: slab untouched -> None
    absent = present.copy()
    absent[:, 0] = (absent[:, 0] + 1) % V
    key_set = {tuple(r) for r in present}
    absent = absent[[tuple(r) not in key_set for r in absent]]
    assert src.apply_delta(add_sids=present[:5], remove_sids=absent) is None
    assert src.apply_delta() is None
    # remove-then-readd of the same SID splices and returns an equal trie
    ft = src.apply_delta(add_sids=present[:3], remove_sids=present[:3])
    assert ft is not None
    assert_tries_equal(ft, build_flat_trie(present, V, dense_d=2))
    assert present[0] in src and absent[0] not in src


def test_apply_delta_transactional_on_error(rng):
    sids = make_sids(rng, 50, V, L)
    src = TrieSource.from_sids(sids, V)
    before = np.asarray(src.sids, dtype=np.int64).copy()
    with pytest.raises(ValueError, match="non-empty"):
        src.apply_delta(remove_sids=before)  # would empty the set
    with pytest.raises(ValueError, match="range"):
        src.apply_delta(add_sids=np.full((2, L), V + 3))
    with pytest.raises(ValueError, match="must be"):
        src.apply_delta(add_sids=np.zeros((2, L + 1), int))
    np.testing.assert_array_equal(np.asarray(src.sids, np.int64), before)
    assert_tries_equal(src.flatten(), build_flat_trie(before, V, dense_d=2))


def test_clone_is_independent(rng):
    sids = make_sids(rng, 60, V, L)
    src = TrieSource.from_sids(sids, V)
    other = src.clone()
    other.apply_delta(remove_sids=np.asarray(src.sids[:10], np.int64))
    assert src.n_sids == np.unique(sids, axis=0).shape[0]
    assert other.n_sids == src.n_sids - 10


def test_virtual_id_boundary_vocab_raises():
    """Virtual l0 ids reach vocab_size under dense_d >= 2: at V = 2^15 an
    int16 index would wrap, so the capacity guard covers V itself."""
    sids = np.array([[32767, 1], [5, 2]])
    with pytest.raises(ValueError, match="int16"):
        TrieSource.from_sids(sids, 32768, dense_d=2,
                             index_dtype=np.int16).flatten()


def test_index_capacity_guard_small_dtypes(rng):
    sids = make_sids(rng, 300, V, L)
    with pytest.raises(ValueError, match="int8"):
        TrieSource.from_sids(sids, V, dense_d=0,
                             index_dtype=np.int8).flatten()
    big = TrieSource.from_sids(sids, V, dense_d=0,
                               index_dtype=np.int64).flatten()
    assert big.edges.dtype == np.int64
    assert_tries_equal(
        big, build_flat_trie(sids, V, dense_d=0, index_dtype=np.int64))


# ---------------------------------------------------------------------------
# registry: build / swap / swap_delta against the reference registry
# ---------------------------------------------------------------------------
def unique_catalog(rng, n):
    """SID-unique catalog as host arrays (the swap_delta contract)."""
    sids = np.unique(make_sids(rng, n, V, L, clustered=True), axis=0)
    m = sids.shape[0]
    return dict(sids=sids, age_days=rng.uniform(0, 60, m),
                category=rng.integers(0, 4, m))


def make_delta(rng, cat, n_rm=10, n_add=25):
    """(removed SIDs, added catalog arrays) of a seeded churn delta."""
    rm = cat["sids"][rng.choice(cat["sids"].shape[0], n_rm, replace=False)]
    added = unique_catalog(rng, n_add)
    seen = {tuple(r) for r in cat["sids"]}
    keep = np.array([tuple(r) not in seen for r in added["sids"]], bool)
    return rm, {k: v[keep] for k, v in added.items()}


def port_delta(rm, added):
    return CatalogDelta(added=ItemCatalog(**added) if added else None,
                        removed_sids=rm)


def jax_delta(rm, added):
    return JaxCatalogDelta(added=JaxItemCatalog(**added) if added else None,
                           removed_sids=rm)


def two_slot_registry(headroom=0.5):
    reg = ConstraintRegistry(V, headroom=headroom, device="cpu")
    reg.register("fresh", freshness_window(30))
    reg.register("cats", category_allowlist(0, 1))
    return reg


def jax_two_slot_registry(headroom=0.5):
    reg = JaxConstraintRegistry(V, headroom=headroom)
    reg.register("fresh", jax_freshness_window(30))
    reg.register("cats", jax_category_allowlist(0, 1))
    return reg


def test_registry_matches_reference_through_build_swap_and_delta(rng):
    cat = unique_catalog(rng, 300)
    reg, ref = two_slot_registry(), jax_two_slot_registry()
    assert_stores_equal(reg.build(ItemCatalog(**cat)),
                        ref.build(JaxItemCatalog(**cat)))
    rm, added = make_delta(rng, cat)
    assert reg.swap_delta(port_delta(rm, added)) == 2
    assert ref.swap_delta(jax_delta(rm, added)) == 2
    assert_stores_equal(reg.current()[0], ref.current()[0])
    assert reg.last_delta_seconds.keys() == {"assemble", "upload", "flip"}
    snap = unique_catalog(rng, 280)
    assert reg.swap(ItemCatalog(**snap)) == ref.swap(JaxItemCatalog(**snap))
    assert_stores_equal(reg.current()[0], ref.current()[0])
    for slot in range(2):
        np.testing.assert_array_equal(reg.slot_sids(slot), ref.slot_sids(slot))
    assert reg.envelope_generation == ref.envelope_generation == 1
    assert _gauges(reg) == _gauges(ref)


def _gauges(reg):
    """The registry's gauge values (its histograms hold wall times)."""
    snap = reg.metrics.snapshot()
    return snap["gauges"], {k: v for k, v in snap["counters"].items()}


def test_swap_delta_matches_full_swap(rng):
    cat = unique_catalog(rng, 300)
    reg, ref = two_slot_registry(), two_slot_registry()
    reg.build(ItemCatalog(**cat))
    ref.build(ItemCatalog(**cat))
    rm, added = make_delta(rng, cat)
    delta = port_delta(rm, added)
    assert reg.swap_delta(delta) == 2
    cat2 = ItemCatalog(**cat).apply_delta(delta)
    ref.swap(cat2)
    assert_stores_equal(reg.current()[0], ref.current()[0])
    # a second delta chained on the retained sources still matches
    rm2, added2 = make_delta(rng, dict(sids=cat2.sids))
    delta2 = port_delta(rm2, added2)
    reg.swap_delta(delta2)
    ref.swap(cat2.apply_delta(delta2))
    assert_stores_equal(reg.current()[0], ref.current()[0])


def test_swap_delta_empty_is_versionless_noop(rng):
    reg = two_slot_registry()
    reg.build(ItemCatalog(**unique_catalog(rng, 200)))
    assert reg.swap_delta(CatalogDelta()) == 1
    assert reg.version == 1


def test_compose_equals_sequential(rng):
    cat = unique_catalog(rng, 250)
    rm, added = make_delta(rng, cat)
    d1 = port_delta(rm, added)
    d2 = CatalogDelta(removed_sids=np.concatenate(
        [cat["sids"][20:24], added["sids"][:2]]))
    base = ItemCatalog(**cat)
    seq = base.apply_delta(d1).apply_delta(d2)
    comp = base.apply_delta(d1.compose(d2))
    np.testing.assert_array_equal(np.unique(seq.sids, axis=0),
                                  np.unique(comp.sids, axis=0))
    # and the reference composes the same delta
    jd = jax_delta(rm, added).compose(
        JaxCatalogDelta(removed_sids=d2.removed_sids))
    np.testing.assert_array_equal(d1.compose(d2).removed_sids, jd.removed_sids)
    np.testing.assert_array_equal(d1.compose(d2).added.sids, jd.added.sids)
    reg_a = two_slot_registry()
    reg_a.build(base)
    reg_a.swap_delta(d1)
    reg_a.swap_delta(d2)
    reg_b = two_slot_registry()
    reg_b.build(base)
    reg_b.swap_delta(d1.compose(d2))
    assert_stores_equal(reg_a.current()[0], reg_b.current()[0])


def test_envelope_regrowth_cold_swap(rng):
    cat = unique_catalog(rng, 80)
    reg = two_slot_registry(headroom=0.0)  # no slack: growth must regrow
    ref = jax_two_slot_registry(headroom=0.0)
    store = reg.build(ItemCatalog(**cat))
    ref.build(JaxItemCatalog(**cat))
    assert reg.envelope_generation == 1
    big = unique_catalog(rng, 2000)
    assert reg.swap(ItemCatalog(**big)) == 2  # default on_overflow="regrow"
    ref.swap(JaxItemCatalog(**big))
    assert reg.envelope_generation == ref.envelope_generation == 2
    grown, _ = reg.current()
    assert grown.n_states > store.n_states
    assert_stores_equal(grown, ref.current()[0])
    # fail-fast mode still raises and leaves the front serving
    with pytest.raises(EnvelopeOverflow):
        reg.swap(ItemCatalog(**unique_catalog(rng, 4000)),
                 on_overflow="raise")
    assert reg.current()[1] == 2 and reg.current()[0] is grown


def test_failed_swap_delta_keeps_sources_consistent(rng):
    """A rejected refresh (envelope overflow, raise mode) must not advance
    the retained per-slot sources past the still-serving front buffer."""
    cat = unique_catalog(rng, 100)
    reg = two_slot_registry(headroom=0.0)
    reg.build(ItemCatalog(**cat))
    huge = CatalogDelta(added=ItemCatalog(**unique_catalog(rng, 3000)))
    with pytest.raises(EnvelopeOverflow):
        reg.swap_delta(huge, on_overflow="raise")
    assert reg.version == 1
    rm, added = make_delta(rng, cat)
    reg.swap_delta(port_delta(rm, added))
    ref = two_slot_registry(headroom=0.0)
    ref.build(ItemCatalog(**cat))
    ref.swap(ItemCatalog(**cat).apply_delta(port_delta(rm, added)))
    assert_stores_equal(reg.current()[0], ref.current()[0])


@pytest.mark.parametrize("kind", ["snapshot", "delta"])
def test_refresher_swap_fault_leaves_front_buffer_consistent(rng, kind):
    """A ``refresh.swap`` fault (the flip about to happen) leaves the front
    store, the version and the retained sources as they were."""
    cat = unique_catalog(rng, 200)
    reg = two_slot_registry()
    front = reg.build(ItemCatalog(**cat))
    before = [reg.slot_sids(s) for s in range(2)]
    rm, added = make_delta(rng, cat)
    inj = FaultInjector([FaultSpec("refresh.swap", mode="always")])
    with active_injector(inj), pytest.raises(Exception, match="refresh.swap"):
        if kind == "snapshot":
            reg.swap(ItemCatalog(**unique_catalog(rng, 220)))
        else:
            reg.swap_delta(port_delta(rm, added))
    assert inj.n_fires("refresh.swap") == 1
    assert reg.current() == (front, 1)
    for s in range(2):
        np.testing.assert_array_equal(reg.slot_sids(s), before[s])
    # the untouched sources still refresh to the right store
    reg.swap_delta(port_delta(rm, added))
    ref = two_slot_registry()
    ref.build(ItemCatalog(**cat))
    ref.swap(ItemCatalog(**cat).apply_delta(port_delta(rm, added)))
    assert_stores_equal(reg.current()[0], ref.current()[0])


def test_traces_identical_across_hot_and_cold_swap(rng):
    """Beam traces after a hot delta swap and after a cold (regrown) swap
    equal those of a from-scratch build of the same snapshot."""
    cat = unique_catalog(rng, 150)
    reg = two_slot_registry(headroom=0.0)
    reg.build(ItemCatalog(**cat))
    table = torch.as_tensor(rng.normal(size=(L, V, V)).astype(np.float32))
    cids = torch.zeros(2, dtype=torch.int32)

    def traced(store):
        def logits_fn(carry, last, step):
            return table[step][last.long()], carry
        state, _, trace = beam_search(
            logits_fn, None, 2, 4, L, DecodePolicy.stacked(store),
            constraint_ids=cids, return_trace=True)
        return state.tokens, state.scores, trace.tokens, trace.scores

    snapshot = ItemCatalog(**cat)
    for delta in (port_delta(*make_delta(rng, cat, n_rm=8, n_add=5)),
                  CatalogDelta(added=ItemCatalog(**unique_catalog(rng, 2000)))):
        gen = reg.envelope_generation
        reg.swap_delta(delta)
        snapshot = snapshot.apply_delta(delta)
        fresh = two_slot_registry(headroom=0.0)
        for g, w in zip(traced(reg.current()[0]),
                        traced(fresh.build(snapshot))):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert reg.envelope_generation == gen + 1  # the second delta regrew


def test_catalog_delta_rejects_mismatched_sid_width(rng):
    """Byte row keys null-pad, so a narrower removed_sids would silently
    match (and delete) the wrong items: it raises instead."""
    cat = ItemCatalog(**unique_catalog(rng, 100))
    narrow = np.asarray(cat.sids[:, :L - 1])
    with pytest.raises(ValueError, match="sid_length"):
        cat.apply_delta(CatalogDelta(removed_sids=narrow))
    with pytest.raises(ValueError, match="sid_length"):
        CatalogDelta(added=ItemCatalog(**unique_catalog(rng, 10)),
                     removed_sids=narrow)
    d1 = CatalogDelta(added=ItemCatalog(**unique_catalog(rng, 10)))
    with pytest.raises(ValueError, match="sid_length"):
        d1.compose(CatalogDelta(removed_sids=narrow))
    wide = ItemCatalog(sids=np.zeros((3, L + 1), np.int64),
                       age_days=np.zeros(3), category=np.zeros(3, np.int64))
    with pytest.raises(ValueError, match="sid_length"):
        cat.apply_delta(CatalogDelta(added=wide))


# ---------------------------------------------------------------------------
# AsyncRefresher: futures, coalescing, backpressure, error propagation
# ---------------------------------------------------------------------------
def test_async_refresher_applies_and_propagates_errors(rng):
    cat = unique_catalog(rng, 250)
    reg = two_slot_registry()
    reg.build(ItemCatalog(**cat))
    with AsyncRefresher(reg) as ref:
        d = port_delta(*make_delta(rng, cat))
        assert ref.apply_delta_async(d).result(timeout=30) == 2
        snap = ItemCatalog(**cat).apply_delta(d)
        assert ref.swap_async(snap).result(timeout=30) == 3
        # a predicate failure propagates through the future; the front
        # buffer keeps serving the previous version
        stale = ItemCatalog(sids=snap.sids,
                            age_days=np.full(snap.sids.shape[0], 1e9),
                            category=snap.category)
        with pytest.raises(ValueError, match="zero items"):
            ref.swap_async(stale).result(timeout=30)
        assert ref.failed == 1 and reg.version == 3
        more = port_delta(*make_delta(rng, dict(sids=snap.sids)))
        assert ref.apply_delta_async(more).result(30) == 4
        assert ref.staleness_seconds() == 0.0
    with pytest.raises(RuntimeError, match="closed"):
        ref.swap_async(snap)


def test_async_refresher_coalesces_superseded_snapshots(rng):
    reg = two_slot_registry()
    reg.build(ItemCatalog(**unique_catalog(rng, 200)))
    ref = AsyncRefresher(reg)
    try:
        with reg._refresh_lock:  # stall the worker mid-op
            futs = [ref.swap_async(ItemCatalog(**unique_catalog(
                rng, 200 + 10 * i))) for i in range(4)]
            time.sleep(0.05)  # let the worker pick up the first op
            assert ref.staleness_seconds() > 0.0
        versions = {f.result(timeout=30) for f in futs}
        # the first op may run alone; the rest collapse into ONE build
        assert ref.coalesced >= 2
        assert reg.version <= 3 and versions <= {2, 3}
    finally:
        ref.close()


def test_async_refresher_backpressure_blocks_when_full(rng):
    reg = two_slot_registry()
    reg.build(ItemCatalog(**unique_catalog(rng, 200)))
    ref = AsyncRefresher(reg, coalesce=False, max_pending=1)
    try:
        submitted = threading.Event()
        with reg._refresh_lock:  # worker stalls; queue fills
            f1 = ref.swap_async(ItemCatalog(**unique_catalog(rng, 210)))
            time.sleep(0.05)  # worker takes f1's op; queue empty again
            f2 = ref.swap_async(ItemCatalog(**unique_catalog(rng, 220)))
            third = ItemCatalog(**unique_catalog(rng, 230))

            def submit_third():
                ref.swap_async(third)
                submitted.set()

            t = threading.Thread(target=submit_third, daemon=True)
            t.start()
            time.sleep(0.1)
            assert not submitted.is_set()  # blocked: queue full
        assert submitted.wait(timeout=30)  # unblocks once the worker drains
        assert f1.result(30) and f2.result(30)
        assert ref.drain(timeout=30)
        t.join(timeout=30)
        assert not t.is_alive()
        assert ref.metrics.counter(
            "refresh_backpressure_waits_total").total() >= 1
    finally:
        ref.close()


def test_async_refresher_survives_cancelled_future(rng):
    """Cancelling a queued future drops its notification and does not kill
    the worker (set_result on a cancelled Future would raise)."""
    cat = unique_catalog(rng, 200)
    reg = two_slot_registry()
    reg.build(ItemCatalog(**cat))
    with AsyncRefresher(reg) as ref:
        with reg._refresh_lock:  # stall the worker so ops stay queued
            f1 = ref.swap_async(ItemCatalog(**unique_catalog(rng, 210)))
            time.sleep(0.05)  # worker picks up f1's op
            f2 = ref.apply_delta_async(port_delta(*make_delta(rng, cat)))
            assert f2.cancel()  # still queued: cancellable
        assert f1.result(timeout=30) == 2
        assert ref.drain(timeout=30)
        f3 = ref.swap_async(ItemCatalog(**unique_catalog(rng, 220)))
        assert f3.result(timeout=30) >= 3


def test_async_refresher_retries_transient_build_faults(rng):
    """Two injected ``refresh.build`` failures are retried away; the op
    applies once and the retries are counted."""
    reg = two_slot_registry()
    reg.build(ItemCatalog(**unique_catalog(rng, 200)))
    inj = FaultInjector([FaultSpec("refresh.build", mode="always",
                                   max_fires=2)])
    with active_injector(inj), AsyncRefresher(reg) as ref:
        assert ref.swap_async(
            ItemCatalog(**unique_catalog(rng, 210))).result(30) == 2
        assert ref.metrics.counter("refresh_retries_total").total() == 2
    assert inj.n_fires("refresh.build") == 2


def test_registry_compliance_of_served_beams(rng):
    """Each slot's live beams lie in ``slot_sids`` (the ground truth the
    chip run checks served SIDs against)."""
    cat = unique_catalog(rng, 300)
    reg = two_slot_registry()
    store = reg.build(ItemCatalog(**cat))
    table = torch.as_tensor(rng.normal(size=(L, V, V)).astype(np.float32))
    cids = torch.tensor([0, 1], dtype=torch.int32)
    state, _ = beam_search(lambda c, last, s: (table[s][last.long()], c),
                           None, 2, 4, L, DecodePolicy.stacked(store),
                           constraint_ids=cids)
    for row in range(2):
        valid = {tuple(r) for r in reg.slot_sids(row).astype(np.int64)}
        for m in range(4):
            if float(state.scores[row, m]) > NEG_INF / 2:
                assert tuple(state.tokens[row, m].tolist()) in valid


def test_current_is_consistent_under_concurrent_swaps(rng):
    """Readers on more threads than cores never see a store paired with
    another version's number while the refresher flips, with a short
    switch interval to force interleavings."""
    n = 120
    sids = np.unique(make_sids(rng, n, V, L), axis=0)
    n = sids.shape[0]
    reg = two_slot_registry()  # age 0, category 0: both slots hold all
    reg.build(ItemCatalog(sids=sids, age_days=np.zeros(n),
                          category=np.zeros(n, np.int64)))
    bad, seen, stop = [], set(), threading.Event()

    def read():
        while not stop.is_set():
            store, version = reg.current()
            got = store.member_n_constraints.tolist()
            if got != [n - (version - 1)] * 2:  # one SID removed a version
                bad.append((version, got))
            seen.add(version)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    readers = [threading.Thread(target=read, daemon=True)
               for _ in range((os.cpu_count() or 1) + 1)]
    try:
        for t in readers:
            t.start()
        with AsyncRefresher(reg, coalesce=False, max_pending=64) as ref:
            futs = [ref.apply_delta_async(CatalogDelta(
                removed_sids=sids[i:i + 1])) for i in range(20)]
            assert [f.result(timeout=60) for f in futs] == list(range(2, 22))
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for t in readers:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in readers)
    assert not bad and 21 in seen and len(seen) > 1
