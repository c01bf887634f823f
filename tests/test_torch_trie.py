"""Port trie builder and transition matrix against the JAX reference."""
import pathlib

import numpy as np
import pytest
import torch

from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.core.trie import build_flat_trie as jax_build_flat_trie
from repro_torch.convert import transition_matrix_from_numpy
from repro_torch.core import TransitionMatrix
from repro_torch.core.trie import build_flat_trie

from conftest import make_sids

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
ARRAYS = ("row_pointers", "edges", "level_offsets", "level_bmax",
          "l0_mask_packed", "l0_states", "l1_mask_packed", "l1_states")
TM_FIELDS = ("row_pointers", "edges", "l0_mask_packed", "l0_states",
             "l1_mask_packed", "l1_states")
TM_META = ("vocab_size", "sid_length", "dense_d", "level_bmax", "n_states",
           "n_edges", "n_constraints")


@pytest.mark.parametrize("dense_d", [0, 1, 2])
@pytest.mark.parametrize("clustered", [False, True])
def test_build_flat_trie_matches_reference(rng, dense_d, clustered):
    sids = make_sids(rng, 600, 24, 5, clustered=clustered)
    got = build_flat_trie(sids, 24, dense_d=dense_d)
    want = jax_build_flat_trie(sids, 24, dense_d=dense_d)
    for f in ("vocab_size", "sid_length", "n_constraints", "n_states",
              "n_edges", "dense_d"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ARRAYS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    # the tail pad covers a speculative burst of any level's bmax
    assert got.edges.shape[0] - got.n_edges >= got.level_bmax.max()
    np.testing.assert_array_equal(got.edges[got.n_edges:], 0)


def test_int64_build_matches_reference(rng):
    sids = make_sids(rng, 200, 16, 4)
    got = build_flat_trie(sids, 16, dense_d=1, index_dtype=np.int64)
    want = jax_build_flat_trie(sids, 16, dense_d=1, index_dtype=np.int64)
    for f in ("row_pointers", "edges", "l0_states"):
        assert getattr(got, f).dtype == np.int64
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_golden_trie_loads_and_round_trips(tmp_path):
    tm = TransitionMatrix.load(GOLDEN / "trie_small.npz", device="cpu")
    want = JaxTransitionMatrix.load(GOLDEN / "trie_small.npz")
    for f in TM_META:
        assert getattr(tm, f) == getattr(want, f), f
    for f in TM_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    path = tmp_path / "trie.npz"
    tm.save(path)
    again = JaxTransitionMatrix.load(path)  # the reference reads the port's file
    for f in TM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(again, f)),
                                      getattr(tm, f).numpy(), err_msg=f)
    for f in TM_META:
        assert getattr(again, f) == getattr(tm, f), f


@pytest.mark.parametrize("dense_d", [0, 2])
def test_from_sids_matches_reference_matrix(rng, dense_d):
    sids = make_sids(rng, 300, 20, 4, clustered=True)
    tm = TransitionMatrix.from_sids(sids, 20, dense_d=dense_d, device="cpu")
    ref = transition_matrix_from_numpy(
        JaxTransitionMatrix.from_sids(sids, 20, dense_d=dense_d), device="cpu")
    for f in TM_META:
        assert getattr(tm, f) == getattr(ref, f), f
    for f in TM_FIELDS:
        assert torch.equal(getattr(tm, f), getattr(ref, f)), f
    assert tm.nbytes() == ref.nbytes()
    assert tm.to("cpu").device.type == "cpu"


def test_entry_points_need_cuda_unless_cpu_is_named(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    sids = make_sids(rng, 50, 8, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransitionMatrix.from_sids(sids, 8)
