"""Port ConstraintStore against the JAX reference store.

Both packages stack the same members (the port's converted with
``transition_matrix_from_numpy``); every table, count and static field must
be equal, array for array, through construction, hot swaps and the npz
files either package writes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.constraints import ConstraintStore as JaxConstraintStore
from repro.constraints.store import _edge_capacity as jax_edge_capacity
from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.core.trie import build_flat_trie as jax_build_flat_trie
from repro_torch.constraints import ConstraintStore, EnvelopeOverflow
from repro_torch.constraints.store import _LEAF_FIELDS, _edge_capacity
from repro_torch.convert import store_from_numpy, transition_matrix_from_numpy
from repro_torch.core import TransitionMatrix
from repro_torch.core.trie import build_flat_trie
from repro_torch.kernels import vntk as kv

from conftest import make_sids

V, L = 16, 4
SET_SIZES = (40, 120, 300)
STATIC = ("vocab_size", "sid_length", "dense_d", "level_bmax", "n_states",
          "n_edges", "num_sets")


def _members(rng, dense_d=2, sizes=SET_SIZES):
    jmats = [JaxTransitionMatrix.from_sids(
        make_sids(rng, n, V, L, clustered=True), V, dense_d=dense_d)
        for n in sizes]
    return jmats, [transition_matrix_from_numpy(m, device="cpu") for m in jmats]


def assert_store_equal(got: ConstraintStore, want):
    """``got`` (port) equals ``want`` (either package), field for field."""
    for f in _LEAF_FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    for f in STATIC:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("headroom", [0.0, 0.25])
def test_from_matrices_matches_reference(rng, headroom):
    jmats, mats = _members(rng)
    want = JaxConstraintStore.from_matrices(jmats, headroom=headroom)
    got = ConstraintStore.from_matrices(mats, headroom=headroom, device="cpu")
    assert_store_equal(got, want)
    assert got.is_stacked and got.num_sets == 3
    assert got.row_pointers.shape == (3, got.n_states + 1)
    assert got.edges.shape == (3, got.n_edges, 2)
    assert got.nbytes() == sum(np.asarray(getattr(want, f)).nbytes
                               for f in _LEAF_FIELDS)


@pytest.mark.parametrize("n_edges,bmax", [(0, 1), (100, 16), (1000, 128),
                                          (7, 300)])
def test_edge_capacity_matches_reference(n_edges, bmax):
    assert _edge_capacity(n_edges, bmax) == jax_edge_capacity(n_edges, bmax)


def test_from_matrices_validation(rng):
    _, mats = _members(rng, sizes=(20,))
    other_vocab = TransitionMatrix.from_sids(make_sids(rng, 20, 8, L), 8,
                                             device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ConstraintStore.from_matrices(mats + [other_vocab], device="cpu")
    other_dense = TransitionMatrix.from_sids(make_sids(rng, 20, V, L), V,
                                             dense_d=0, device="cpu")
    with pytest.raises(ValueError, match="dense_d"):
        ConstraintStore.from_matrices(mats + [other_dense], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        ConstraintStore.from_matrices([], device="cpu")
    with pytest.raises(ValueError, match="headroom"):
        ConstraintStore.from_matrices(mats, headroom=-0.1, device="cpu")


def test_member_lookups_match_the_original(rng):
    jmats, mats = _members(rng)
    store = ConstraintStore.from_matrices(mats, headroom=0.5, device="cpu")
    jstore = JaxConstraintStore.from_matrices(jmats, headroom=0.5)
    for k, tm in enumerate(mats):
        member = store.member(k)
        jm = jstore.member(k)
        for f in ("n_states", "n_edges", "n_constraints", "level_bmax"):
            assert getattr(member, f) == getattr(jm, f), f
        assert member.n_states == tm.n_states
        np.testing.assert_array_equal(member.edges.numpy(),
                                      np.asarray(jm.edges))
        nodes = torch.arange(tm.n_states + 1, dtype=torch.int32)
        nodes[-1] = 0  # the sink
        lp = torch.from_numpy(rng.normal(size=(len(nodes), V)).astype(
            np.float32))
        bmax = max(tm.level_bmax)
        a = kv.vntk_mask_plain(lp, nodes, tm.row_pointers, tm.edges, bmax, V)
        b = kv.vntk_mask_plain(lp, nodes, member.row_pointers, member.edges,
                               bmax, V)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(IndexError):
        store.member(3)


def test_with_member_matches_reference_and_keeps_the_old_store(rng):
    jmats, mats = _members(rng)
    jstore = JaxConstraintStore.from_matrices(jmats, headroom=0.5)
    store = ConstraintStore.from_matrices(mats, headroom=0.5, device="cpu")
    before = {f: getattr(store, f).clone() for f in _LEAF_FIELDS}
    jfresh = JaxTransitionMatrix.from_sids(
        make_sids(rng, 150, V, L, clustered=True), V, dense_d=2)
    fresh = transition_matrix_from_numpy(jfresh, device="cpu")
    swapped = store.with_member(1, fresh)
    assert_store_equal(swapped, jstore.with_member(1, jfresh))
    for f in _LEAF_FIELDS:  # functional: the reader's store is unchanged
        assert torch.equal(getattr(store, f), before[f]), f
    with pytest.raises(IndexError):
        store.with_member(3, fresh)


def test_with_members_matches_reference_and_chained_swaps(rng):
    jmats, mats = _members(rng)
    jstore = JaxConstraintStore.from_matrices(jmats, headroom=0.5)
    store = ConstraintStore.from_matrices(mats, headroom=0.5, device="cpu")
    jfresh, fresh = _members(rng, sizes=(50, 90, 200))
    bulk = store.with_members(fresh)
    assert_store_equal(bulk, jstore.with_members(jfresh))
    chained = store
    for k, tm in enumerate(fresh):
        chained = chained.with_member(k, tm)
    assert_store_equal(bulk, chained)
    with pytest.raises(ValueError, match="matrices"):
        store.with_members(fresh[:2])


@pytest.mark.parametrize("what", ["states", "edge rows", "branch factor"])
def test_envelope_overflow(rng, what):
    _, mats = _members(rng, sizes=(60, 60))
    store = ConstraintStore.from_matrices(mats, headroom=0.0, device="cpu")
    tm = store.member(0)
    if what == "states":
        big = TransitionMatrix.from_sids(make_sids(rng, 2000, V, L), V,
                                         device="cpu")
    elif what == "edge rows":
        big = dataclasses.replace(tm, n_edges=store.n_edges)
    else:
        big = dataclasses.replace(
            tm, level_bmax=tm.level_bmax[:-1] + (tm.level_bmax[-1] + 1,))
    with pytest.raises(EnvelopeOverflow, match=what):
        store.with_member(0, big)
    assert issubclass(EnvelopeOverflow, ValueError)


def test_zero_headroom_store_accepts_its_own_members(rng):
    _, mats = _members(rng)
    store = ConstraintStore.from_matrices(mats, headroom=0.0, device="cpu")
    members = [store.member(k) for k in range(store.num_sets)]
    for k, m in enumerate(members):
        assert m.n_states == int(store.member_n_states[k])
        assert m.n_edges == int(store.member_n_edges[k])
    assert_store_equal(store.with_members(members), store)
    assert_store_equal(store.with_member(1, members[1]), store)
    assert_store_equal(store.with_members(mats), store)


def test_from_matrices_index_capacity_guard(rng):
    sids = make_sids(rng, 2000, V, L)
    small = TransitionMatrix.from_flat_trie(
        build_flat_trie(sids, V, index_dtype=np.int16), device="cpu")
    with pytest.raises(ValueError, match="int16"):
        ConstraintStore.from_matrices([small], headroom=8.0, device="cpu")
    jsmall = JaxTransitionMatrix.from_flat_trie(
        jax_build_flat_trie(sids, V, index_dtype=np.int16))
    ok = ConstraintStore.from_matrices([small], headroom=0.1, device="cpu")
    assert_store_equal(ok, JaxConstraintStore.from_matrices([jsmall],
                                                            headroom=0.1))


def test_npz_files_cross_between_packages(tmp_path, rng):
    jmats, mats = _members(rng)
    jstore = JaxConstraintStore.from_matrices(jmats, headroom=0.4)
    jstore.save(str(tmp_path / "jax.npz"))
    loaded = ConstraintStore.load(str(tmp_path / "jax.npz"), device="cpu")
    assert_store_equal(loaded, jstore)
    store = ConstraintStore.from_matrices(mats, headroom=0.4, device="cpu")
    store.save(str(tmp_path / "port.npz"))
    back = JaxConstraintStore.load(str(tmp_path / "port.npz"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jstore)
    assert_store_equal(store, back)
    assert_store_equal(ConstraintStore.load(str(tmp_path / "port.npz"),
                                            device="cpu"), store)


def test_store_from_numpy_and_to(rng):
    jmats, _ = _members(rng)
    jstore = JaxConstraintStore.from_matrices(jmats, headroom=0.3)
    store = store_from_numpy(jstore, device="cpu")
    assert_store_equal(store, jstore)
    assert store.device == torch.device("cpu")
    assert_store_equal(store.to("cpu"), jstore)
    assert store.bmax_for_step(2) == jstore.bmax_for_step(2)
