"""The plain reference against the port's CPU path at a tiny float32 size."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench.harness import data
from gpubench.reference.decoder import Decoder
from gpubench.reference.search import beam_scores, search
from gpubench.reference.sets import Catalog, SidSet
from gpubench.systems.gr_retrieval import port_params
from gpubench.tests.tinyroot import one_thread

MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 66, "tie_embeddings": True,
         "rope_theta": 10000.0, "norm_eps": 1e-5, "dtype": "float32"}
V, L, M = 64, 4, 8


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _port(model=MODEL, seed=3):
    from repro_torch.configs.base import TransformerConfig

    w = data.make_weights(model, seed, "cpu")
    tcfg = TransformerConfig(
        name="tiny", **{k: model[k] for k in (
            "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size", "head_dim", "tie_embeddings", "rope_theta",
            "norm_eps", "dtype")})
    return w, port_params(w, model["n_layers"]), tcfg


def test_history_logits_match_the_port_prefill():
    from repro_torch.models import transformer

    w, params, tcfg = _port()
    tokens = torch.randint(0, V, (3, 32), generator=torch.Generator()
                           .manual_seed(0))
    dec = Decoder(w, MODEL)
    port_logits, _ = transformer.prefill(params, tokens, tcfg)
    for b in range(3):
        ref = dec.history(tokens[b]).last_logits
        torch.testing.assert_close(ref, port_logits[b, 0], rtol=1e-4,
                                   atol=1e-5)


def test_suffix_logits_match_the_port_forward():
    from repro_torch.models import transformer

    w, params, tcfg = _port()
    g = torch.Generator().manual_seed(1)
    hist = torch.randint(0, V, (16,), generator=g)
    suffix = torch.randint(0, V, (5, 3), generator=g)
    full = torch.cat([hist.expand(5, 16), suffix], dim=1)
    x, _, _ = transformer.forward(params, full, tcfg)
    port = x @ params["emb"].T
    dec = Decoder(w, MODEL)
    got = dec.suffix_logits(dec.history(hist), suffix)
    torch.testing.assert_close(got, port[:, 16:], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(
        dec.suffix_logits(dec.history(hist), suffix, last_only=True),
        port[:, -1], rtol=1e-4, atol=1e-5)


def test_fp8_control_departs_from_float32():
    w, _, _ = _port()
    tokens = torch.arange(20) % V
    f32 = Decoder(w, MODEL).history(tokens).last_logits
    fp8 = Decoder(w, MODEL, "fp8").history(tokens).last_logits
    gap = (f32 - fp8).abs().max().item()
    assert 1e-3 < gap < 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_search_and_scores_match_the_port_retrieve(seed):
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.trie import build_flat_trie
    from repro_torch.decoding import DecodePolicy
    from repro_torch.serving import GenerativeRetriever

    w, params, tcfg = _port(seed=seed)
    sids = data.make_catalog(2000, L, V, seed, "cpu")
    tm = TransitionMatrix.from_flat_trie(build_flat_trie(sids, V, dense_d=2),
                                         device="cpu")
    retriever = GenerativeRetriever(params, tcfg, DecodePolicy.static(tm),
                                    L, V, beam_size=M)
    hist = np.random.default_rng(seed).integers(0, V, (2, 24))
    beams, scores = retriever.retrieve(hist)
    dec = Decoder(w, MODEL)
    cat = Catalog(sids, V)
    for b in range(2):
        h = dec.history(torch.as_tensor(hist[b]))
        ref, _ = beam_scores(dec, h, beams[b].astype(np.int64), V)
        np.testing.assert_allclose(ref, scores[b], rtol=1e-5, atol=1e-4)
        mine, mine_scores = search(dec, h, cat.set(None), M, L, V)
        np.testing.assert_array_equal(mine, beams[b])
        np.testing.assert_allclose(mine_scores, scores[b], rtol=1e-5,
                                   atol=1e-4)


def test_sets_against_plain_python():
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 6, (400, 3))
    meta = {"age_days": rng.uniform(0, 90, 400),
            "category": rng.integers(0, 8, 400)}
    slots = [{"predicate": "freshness_window", "args": [30.0]},
             {"predicate": "category_allowlist", "args": [0, 1]}]
    cat = Catalog(raw, 6, meta, slots)  # unsorted, with repeats: sorted here
    rows = [tuple(r) for r in cat.sids.tolist()]
    assert rows == sorted(set(map(tuple, raw.tolist())))
    assert len(cat.meta["age_days"]) == len(rows)
    want = {None: set(rows),
            0: {r for r, a in zip(rows, cat.meta["age_days"]) if a <= 30.0},
            1: {r for r, c in zip(rows, cat.meta["category"]) if c in (0, 1)}}
    queries = np.array([(a, b, c) for a in range(6) for b in range(6)
                        for c in range(6)])
    for cid, members in want.items():
        got = cat.contains(cid, queries)
        assert [tuple(q) in members for q in queries.tolist()] == got.tolist()
        s = cat.set(cid)
        assert len(s) == len(members)
        for prefix in [(), (1,), (2, 3), (4, 4, 4)]:
            lo, hi = s.prefix_range(prefix)
            n = sum(1 for r in members if r[:len(prefix)] == prefix)
            assert hi - lo == n
            if len(prefix) < 3 and n:
                tok, clo, chi = s.children(lo, hi, len(prefix))
                kids = sorted({r[len(prefix)] for r in members
                               if r[:len(prefix)] == prefix})
                assert tok.tolist() == kids
                assert (chi - clo).sum() == n


def test_first_tokens_and_rows_of():
    sids = np.array([[0, 1], [0, 2], [3, 0]])
    cat = Catalog(sids, 4)
    assert cat.first_tokens(None) == 2
    assert cat.rows_of(np.array([[3, 0], [0, 2], [1, 1]])).tolist() == [2, 1, -1]
    assert isinstance(cat.set(None), SidSet)
