"""The seeded inputs and traffic: sorted unique SIDs, determinism, ranges."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench.harness import data
from gpubench.harness.runner import sample_requests
from gpubench.harness.traffic import (
    Requests,
    make_requests,
    poisson_arrivals,
    zipf_ids,
)

BIG_SEED = 2 ** 40 + 12345  # seeds may pass 32 bits


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_catalog_sorted_unique_and_taken_as_is(seed):
    from repro_torch.core.trie import sorted_unique_sids

    c = data.make_catalog(5000, 8, 2048, seed, "cpu")
    assert c.shape == (5000, 8) and c.dtype == np.int32
    assert c.min() >= 0 and c.max() < 2048
    keys = [tuple(r) for r in c.tolist()]
    assert keys == sorted(set(keys))  # strictly ascending: sorted, unique
    assert sorted_unique_sids(c) is c  # the program skips its sort


def test_catalog_packs_vocabularies_that_are_no_power_of_two():
    c = data.make_catalog(3000, 5, 50, 3, "cpu")
    keys = [tuple(r) for r in c.tolist()]
    assert keys == sorted(set(keys)) and c.max() < 50


def test_same_seed_same_inputs_other_seed_other_inputs():
    model = {"n_layers": 2, "d_model": 32, "n_heads": 4, "n_kv_heads": 2,
             "head_dim": 8, "d_ff": 64, "vocab_size": 40, "dtype": "bfloat16"}
    a = data.make_weights(model, BIG_SEED, "cpu")
    b = data.make_weights(model, BIG_SEED, "cpu")
    c = data.make_weights(model, BIG_SEED + 1, "cpu")
    for k in a:
        assert a[k].dtype == torch.bfloat16
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    assert a["wq"].shape == (2, 32, 32) and a["wk"].shape == (2, 32, 16)
    assert a["w2"].shape == (2, 64, 32) and a["emb"].shape == (40, 32)
    np.testing.assert_array_equal(data.make_catalog(900, 4, 30, 5, "cpu"),
                                  data.make_catalog(900, 4, 30, 5, "cpu"))
    m1 = data.make_meta(1000, 9, "cpu", 90.0, 8)
    m2 = data.make_meta(1000, 9, "cpu", 90.0, 8)
    np.testing.assert_array_equal(m1["age_days"], m2["age_days"])
    assert 0.0 <= m1["age_days"].min() and m1["age_days"].max() < 90.0
    assert set(np.unique(m1["category"])) <= set(range(8))


def test_streams_are_independent_63_bit_seeds():
    seeds = {data.stream_seed(BIG_SEED, s) for s in data.STREAMS}
    assert len(seeds) == len(data.STREAMS)
    assert all(0 <= s < 2 ** 63 for s in seeds)


def test_zipf_ids_in_range_and_falling():
    ids = zipf_ids(np.random.default_rng(0), 20000, 5, 1.0)
    assert ids.min() >= 0 and ids.max() < 5
    counts = np.bincount(ids, minlength=5)
    assert (np.diff(counts) < 0).all()
    assert abs(counts[0] / counts[1] - 2.0) < 0.2


def test_requests_from_the_catalog_and_seeded():
    cat = data.make_catalog(500, 4, 16, 1, "cpu")
    traffic = {"loop": "closed", "batch": 3, "history_items": 5, "pool": 10,
               "constraint_ids": {"dist": "zipf", "s": 1.0}}
    r = make_requests(traffic, cat, 5, BIG_SEED)
    assert r.histories.shape == (10, 20)
    rows = {tuple(x) for x in cat.tolist()}
    assert all(tuple(h[i:i + 4]) in rows for h in r.histories.tolist()
               for i in range(0, 20, 4))
    again = make_requests(traffic, cat, 5, BIG_SEED)
    np.testing.assert_array_equal(r.histories, again.histories)
    np.testing.assert_array_equal(r.cids, again.cids)
    assert [r.round() for _ in range(4)] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                             [9, 0, 1]]
    single = make_requests(dict(traffic, constraint_ids=None), cat, 0, 1)
    assert single.cids is None and single.cid(0) is None
    assert r.seed == BIG_SEED and r.traffic is traffic and r.batch == 3


def test_sample_covers_batch_positions_and_ids():
    served = [{"pos": i % 4, "cid": (i * 7) % 5} for i in range(40)]
    got = sample_requests(served, 9, 3)
    assert len(got) == 9
    assert {r["pos"] for r in got} == set(range(4))
    assert {r["cid"] for r in got} == set(range(5))
    assert sample_requests(served, 9, 3) == got
    assert len(sample_requests(served[:3], 9, 3)) == 3
    assert isinstance(Requests(np.zeros((2, 2)), None, {"batch": 1},
                               0).round(), list)


def test_poisson_arrivals_rate_and_order():
    t = poisson_arrivals(np.random.default_rng(2), 8.0, 40000)
    assert (np.diff(t) > 0).all()
    assert abs(len(t) / t[-1] - 8.0) < 0.2
    gaps = np.diff(t)
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05  # exponential
