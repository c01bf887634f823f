"""Port compressed-slab path (DESIGN.md §11) against the JAX reference.

The level blocks and the slab (single matrix and stacked store, int16 and
int32) are held array for array against the reference's; the plain
versions of the eight compressed CUDA functions against the reference's
oracles, its compressed Pallas kernels in interpret mode and the port's own
uncompressed plain versions; ``compressed=True`` policies against the
port's uncompressed ones, the golden traces and the JAX retriever; the hot
swap against the retriever's policy signature; the memory model against the
reference's.  Integers and unfused scores are equal; fused scores agree
within rtol/atol 1e-5 (each side computes its own log-sum-exp); golden
scores within rtol 1e-6 (1e-5 fused), model scores within 1e-4 (float32
matmul and reduction orders differ between the frameworks).
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro.constraints import ConstraintStore as JaxConstraintStore
from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.core import memory_model as jax_memory_model
from repro.core.beam_search import beam_search as jax_beam_search
from repro.core.compressed_slab import CompressedSlab as JaxCompressedSlab
from repro.core.trie import infer_level_blocks as jax_infer_level_blocks
from repro.decoding import DecodePolicy as JaxDecodePolicy
from repro.kernels import ref
from repro.kernels import vntk as pallas_vntk
from repro.models import transformer as jax_transformer
from repro.serving.generative_retrieval import (
    GenerativeRetriever as JaxGenerativeRetriever,
)
from repro_torch.configs.base import TransformerConfig
from repro_torch.constraints import ConstraintStore
from repro_torch.convert import (
    params_from_jax,
    slab_from_numpy,
    store_from_numpy,
    transition_matrix_from_numpy,
)
from repro_torch.core import TransitionMatrix, memory_model
from repro_torch.core.beam_search import beam_search
from repro_torch.core.compressed_slab import INT16_MAX_VOCAB, CompressedSlab
from repro_torch.core.trie import infer_level_blocks
from repro_torch.core.vntk import candidate_width
from repro_torch.decoding import DecodePolicy
from repro_torch.kernels import ops
from repro_torch.kernels import vntk as kv
from repro_torch.launch.serve import compliance
from repro_torch.serving import GenerativeRetriever
from repro_torch.serving.generative_retrieval import _signature

from conftest import make_sids
from test_torch_vntk import _check, _jax, _torch

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
V, L = 19, 5


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    sids = np.unique(make_sids(rng, 140, V, L, clustered=True), axis=0)
    decoy = np.unique(make_sids(rng, 60, V, L), axis=0)
    table = rng.normal(size=(L, V, V)).astype(np.float32)
    return sids, decoy, table


def _pair(sids, vocab, dense_d):
    """The reference's matrix and the port's copy of it (CPU)."""
    jtm = JaxTransitionMatrix.from_sids(sids, vocab, dense_d=dense_d)
    return jtm, transition_matrix_from_numpy(jtm, device="cpu")


def _blocks_args(tm):
    return dict(n_states=tm.n_states, n_edges=tm.n_edges,
                sid_length=tm.sid_length, dense_d=tm.dense_d,
                vocab_size=tm.vocab_size)


def _assert_slab_equal(got, want):
    assert got.tok_delta.dtype == getattr(torch, np.asarray(
        want.tok_delta).dtype.name)
    np.testing.assert_array_equal(got.tok_delta.numpy(),
                                  np.asarray(want.tok_delta))
    np.testing.assert_array_equal(got.level_base.numpy(),
                                  np.asarray(want.level_base))
    assert got.level_base.dtype == torch.int32
    assert got.nbytes() == want.nbytes()
    assert got.is_stacked == want.is_stacked
    assert (got.vocab_size, got.sid_length) == (want.vocab_size,
                                                want.sid_length)


# ---------------------------------------------------------------------------
# level blocks and the slab
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dense_d", [0, 1, 2])
def test_level_blocks_and_slab_match_reference(corpus, dense_d):
    sids = corpus[0]
    jtm, tm = _pair(sids, V, dense_d)
    want = jax_infer_level_blocks(np.asarray(jtm.row_pointers),
                                  np.asarray(jtm.edges), **_blocks_args(jtm))
    got = infer_level_blocks(tm.row_pointers, tm.edges, **_blocks_args(tm))
    for f in ("edge_offsets", "base", "state_offsets"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    slab = CompressedSlab.from_matrix(tm)
    _assert_slab_equal(slab, JaxCompressedSlab.from_matrix(jtm))
    assert slab.tok_delta.dtype == torch.int16
    assert slab.tok_delta.shape == (tm.edges.shape[0],)
    assert int(slab.base_for_step(L - 1)) == int(want.base[L - 1])
    _assert_slab_equal(slab_from_numpy(JaxCompressedSlab.from_matrix(jtm),
                                       device="cpu"), slab)


def test_int32_slab_above_int16_vocab():
    vocab = INT16_MAX_VOCAB + 9
    sids = np.unique(np.random.default_rng(0).integers(
        0, vocab, size=(25, 3)), axis=0)
    jtm, tm = _pair(sids, vocab, 0)
    slab = CompressedSlab.from_matrix(tm)
    assert slab.tok_delta.dtype == torch.int32
    _assert_slab_equal(slab, JaxCompressedSlab.from_matrix(jtm))


def test_non_canonical_slab_raises(corpus):
    _, tm = _pair(corpus[0], V, 1)
    E = tm.n_edges
    edges = tm.edges.clone()
    edges[:E, 1] = edges[:E, 1].flip(0)  # next states no longer consecutive
    bad = dataclasses.replace(tm, edges=edges)
    with pytest.raises(ValueError, match="non-canonical"):
        infer_level_blocks(bad.row_pointers, bad.edges, **_blocks_args(bad))
    with pytest.raises(ValueError, match="non-canonical"):
        CompressedSlab.from_matrix(bad)
    with pytest.raises(ValueError):  # the reference raises on it too
        jax_infer_level_blocks(bad.row_pointers.numpy(), bad.edges.numpy(),
                               **_blocks_args(bad))
    edges = tm.edges.clone()
    row = int(torch.nonzero(tm.row_pointers[1:] - tm.row_pointers[:-1] > 1)[0])
    lo = int(tm.row_pointers[row])
    edges[lo:lo + 2, 0] = edges[lo:lo + 2, 0].flip(0)  # a descending row
    with pytest.raises(ValueError, match="ascending"):
        CompressedSlab.from_matrix(dataclasses.replace(tm, edges=edges))


@pytest.fixture(scope="module")
def stores(corpus):
    sids, decoy, _ = corpus
    jstore = JaxConstraintStore.from_matrices(
        [JaxTransitionMatrix.from_sids(s, V, dense_d=1)
         for s in (decoy, sids)], headroom=0.3)
    return jstore, store_from_numpy(jstore, device="cpu")


def test_slab_from_store_matches_reference(stores):
    jstore, store = stores
    slab = CompressedSlab.from_store(store)
    _assert_slab_equal(slab, JaxCompressedSlab.from_store(jstore))
    assert slab.tok_delta.shape == (2, store.edges.shape[1])
    assert slab.level_base.shape == (2, L)
    assert CompressedSlab.build(store).is_stacked
    assert not CompressedSlab.build(store.member(1)).is_stacked
    base = slab.base_for_step(2)
    assert base.shape == (2,) and base.stride(0) == L  # a view, no copy


# ---------------------------------------------------------------------------
# the eight plain compressed functions
# ---------------------------------------------------------------------------
def _level_nodes(rng, tm, step, nb):
    """``nb`` nodes of decode step ``step``'s level, a quarter at the sink."""
    blocks = infer_level_blocks(tm.row_pointers, tm.edges, **_blocks_args(tm))
    lo, hi = blocks.state_offsets[step], blocks.state_offsets[step + 1]
    nodes = rng.integers(lo, hi, nb).astype(np.int32)
    nodes[rng.random(nb) < 0.25] = 0
    return nodes


def _values(rng, nb, vocab, fused, ties):
    x = (rng.normal(size=(nb, vocab)) * (4 if fused else 1)).astype(np.float32)
    if ties:  # see test_torch_vntk._case: + 0.0 folds -0.0 into +0.0
        x = np.round(x * 2) / 2 + 0.0
    return x if fused else np.asarray(torch.log_softmax(torch.from_numpy(x),
                                                        -1))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("topk", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_plain_compressed_functions(rng, corpus, stores, stacked, topk,
                                    fused):
    """Each plain function against the reference's oracle, its Pallas
    kernel (interpret mode) and the port's uncompressed plain version, at
    nb = 7 (prime) and 12 with sink rows and tie-heavy values."""
    jstore, store = stores
    width = candidate_width(8, V)
    for nb, step, ties in ((7, 2, True), (12, L - 1, False)):
        if stacked:
            cids = rng.integers(0, 2, nb).astype(np.int32)
            nodes = np.where(
                cids == 1, _level_nodes(rng, store.member(1), step, nb),
                _level_nodes(rng, store.member(0), step, nb)).astype(np.int32)
            jslab = JaxCompressedSlab.from_store(jstore)
            tables = (store.row_pointers, store.edges)
            jrp, bmax = jstore.row_pointers, store.bmax_for_step(step)
        else:
            _, tm = _pair(corpus[0], V, 1)
            jtm = JaxTransitionMatrix.from_sids(corpus[0], V, dense_d=1)
            nodes = _level_nodes(rng, tm, step, nb)
            jslab = JaxCompressedSlab.from_matrix(jtm)
            tables = (tm.row_pointers, tm.edges)
            jrp, bmax = jtm.row_pointers, tm.bmax_for_step(step)
        slab = slab_from_numpy(jslab, device="cpu")
        x = _values(rng, nb, V, fused, ties)
        jbase = jslab.base_for_step(step)
        head = _torch(x, nodes) + ([torch.from_numpy(cids)] if stacked else [])
        jhead = _jax(x, nodes) + (_jax(cids) if stacked else [])
        tail = (bmax, V) + ((width,) if topk else ())
        name = (f"vntk{'_stacked' if stacked else ''}_compressed_"
                f"{'topk' if topk else 'mask'}")
        got = getattr(kv, f"{name}_plain")(
            *head, tables[0], slab.tok_delta, slab.base_for_step(step), *tail,
            fused=fused)
        stem = name.replace("_mask", "")  # the reference's function names
        jargs = (*jhead, jrp, jslab.tok_delta, jbase, *tail)
        want = getattr(pallas_vntk, f"{stem}_pallas")(
            *jargs, fused_logsoftmax=fused, interpret=True)
        oracle = getattr(ref, f"{stem}_ref")(*jargs, fused_logsoftmax=fused)
        tol = dict(rtol=1e-5, atol=1e-5) if fused else dict(rtol=0)
        _check(got, want, **tol)
        _check(got, oracle, **tol)
        twin = getattr(kv, name.replace("_compressed", "") + "_plain")(
            *head, *tables, *tail, fused=fused)
        for g, w in zip(got, twin):  # the uncompressed twin, bit for bit
            assert torch.equal(g, w)


def test_cpu_compressed_routes_to_the_plain_versions(rng, corpus, stores):
    _, tm = _pair(corpus[0], V, 1)
    slab = CompressedSlab.from_matrix(tm)
    nodes = torch.from_numpy(_level_nodes(rng, tm, 2, 6)).reshape(2, 3)
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(2, 3, V)).astype(np.float32)), -1)
    bmax, base = tm.bmax_for_step(2), slab.base_for_step(2)
    before = dict(kv.LAUNCHES)
    for fused in (False, True):
        got = ops.vntk_compressed_topk(lp, nodes, tm.row_pointers,
                                       slab.tok_delta, base, bmax, V, 8,
                                       fused_logsoftmax=fused)
        want = ops.vntk_topk(lp, nodes, tm.row_pointers, tm.edges, bmax, V, 8,
                             fused_logsoftmax=fused)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got = ops.vntk_compressed(lp, nodes, tm.row_pointers, slab.tok_delta,
                                  base, bmax, V, impl="plain",
                                  fused_logsoftmax=fused)
        fn = ops.vntk_fused_logsoftmax if fused else ops.vntk
        want = fn(lp, nodes, tm.row_pointers, tm.edges, bmax, V)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    _, store = stores
    sslab = CompressedSlab.from_store(store)
    cids = torch.tensor([[0, 1, 1], [1, 0, 0]], dtype=torch.int32)
    got = ops.vntk_compressed_topk(lp, nodes, store.row_pointers,
                                   sslab.tok_delta, sslab.base_for_step(2),
                                   store.bmax_for_step(2), V, 8,
                                   constraint_ids=cids)
    want = ops.vntk_topk(lp, nodes, store.row_pointers, store.edges,
                         store.bmax_for_step(2), V, 8, constraint_ids=cids)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kv.LAUNCHES == before  # no kernel launched on CPU tensors
    assert {f"vntk{s}_compressed_{k}{f}" for s in ("", "_stacked")
            for k in ("topk", "mask") for f in ("", "_fused")} <= set(
                kv.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kv.vntk_compressed_topk_cuda(lp.reshape(6, V), nodes.reshape(-1),
                                     tm.row_pointers, slab.tok_delta, base,
                                     bmax, V, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kv.vntk_stacked_compressed_mask_cuda(
            lp.reshape(6, V), nodes.reshape(-1), cids.reshape(-1),
            store.row_pointers, sslab.tok_delta, sslab.base_for_step(2),
            bmax, V, fused=True)


# ---------------------------------------------------------------------------
# policies: bit-identity, golden traces, hot swap
# ---------------------------------------------------------------------------
def _search(table, policy, stacked, batch=3, beams=6, return_trace=False):
    t = torch.from_numpy(table)

    def logits_fn(carry, last, step):
        return t[step][last.long()], carry

    cids = torch.ones(batch, dtype=torch.int32) if stacked else None
    return beam_search(logits_fn, None, batch, beams, table.shape[0], policy,
                       constraint_ids=cids, return_trace=return_trace)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("topk", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_compressed_policy_bit_identical(corpus, stores, stacked, topk,
                                         fused):
    """``compressed=True`` against the port's uncompressed policy (bit for
    bit) and the reference's compressed policy (tokens equal)."""
    sids, _, table = corpus
    if stacked:
        jtables, tables = stores
    else:
        jtables, tables = _pair(sids, V, 1)
    base = DecodePolicy.static(tables, topk=topk, fused=fused)
    comp = DecodePolicy.static(tables, topk=topk, fused=fused,
                               compressed=True)
    assert "+slab" in comp.describe() and "+slab" not in base.describe()
    want, _ = _search(table, base, stacked)
    got, _ = _search(table, comp, stacked)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.scores, want.scores)

    def jfn(carry, last, step):
        return jnp.asarray(table)[step][last], carry

    jpolicy = JaxDecodePolicy.static(jtables, topk=topk, fused=fused,
                                     compressed=True)
    jstate, _ = jax_beam_search(
        jfn, None, 3, 6, L, jpolicy,
        constraint_ids=jnp.ones(3, jnp.int32) if stacked else None)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(jstate.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(jstate.scores),
                               rtol=1e-5 if fused else 1e-6)


def test_fully_dense_plan_builds_no_slab(corpus):
    tm = TransitionMatrix.from_sids(corpus[0][:, :2], V, dense_d=2,
                                    device="cpu")
    policy = DecodePolicy.static(tm, compressed=True)
    assert all(b.slab is None for b in policy.backends)


@pytest.mark.parametrize("name", ["static", "static_d0", "stacked"])
def test_compressed_golden_traces(name):
    """The golden traces replayed through ``compressed=True`` policies, as
    ``tests/test_golden_traces.py`` replays them for the reference."""
    inputs = np.load(GOLDEN / "inputs.npz")
    traces = np.load(GOLDEN / "traces.npz")
    table = inputs["table"]
    vocab = table.shape[-1]
    tm = TransitionMatrix.load(GOLDEN / "trie_small.npz", device="cpu")
    if name == "static":
        policy = DecodePolicy.static(tm, compressed=True)
    elif name == "static_d0":
        policy = DecodePolicy.static(TransitionMatrix.from_sids(
            inputs["sids"], vocab, dense_d=0, device="cpu"), compressed=True)
    else:
        store = ConstraintStore.from_matrices(
            [TransitionMatrix.from_sids(inputs["decoy"], vocab, dense_d=2,
                                        device="cpu"), tm],
            headroom=0.2, device="cpu")
        policy = DecodePolicy.stacked(store, compressed=True)
    for topk in (True, False):
        state, _, trace = _search(table, policy.with_topk(topk),
                                  name == "stacked", batch=2, beams=4,
                                  return_trace=True)
        np.testing.assert_array_equal(state.tokens.numpy(),
                                      traces[f"{name}_tokens"])
        np.testing.assert_array_equal(trace.tokens.numpy(),
                                      traces[f"{name}_trace_tokens"])
        np.testing.assert_allclose(trace.scores.numpy(),
                                   traces[f"{name}_trace_scores"], rtol=1e-6)


# ---------------------------------------------------------------------------
# the retriever
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def retrieval():
    V_, L_, B, S = 32, 4, 3, 10
    jcfg = JaxTransformerConfig(
        name="gr-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=34, dtype="float32", tie_embeddings=True,
        attn_chunk_q=8)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7)
    sets = [make_sids(rng, n, V_, L_) for n in (60, 400, 150)]
    jstore = JaxConstraintStore.from_matrices(
        [JaxTransitionMatrix.from_sids(s, V_, dense_d=2) for s in sets],
        headroom=0.5)
    jparams = jax_transformer.init_params(jcfg, jax.random.key(7))
    return dict(
        V=V_, L=L_, B=B, jcfg=jcfg, cfg=cfg, sets=sets, jstore=jstore,
        store=store_from_numpy(jstore, device="cpu"), jparams=jparams,
        hist=rng.integers(0, jcfg.vocab_size, (B, S)),
        params=params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu"))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kw", [{}, dict(topk=False, fused=True)])
def test_compressed_retrieve_matches_reference(retrieval, stacked, kw):
    s, M = retrieval, 5
    jtables = s["jstore"] if stacked else s["jstore"].member(1)
    tables = s["store"] if stacked else s["store"].member(1)
    cids = np.array([1, 2, 0], np.int32) if stacked else None
    want_sids, want_scores = JaxGenerativeRetriever(
        s["jparams"], s["jcfg"],
        JaxDecodePolicy.static(jtables, compressed=True, **kw), s["L"],
        s["V"], beam_size=M).retrieve(s["hist"], cids)
    r = GenerativeRetriever(
        s["params"], s["cfg"], DecodePolicy.static(tables, compressed=True,
                                                   **kw),
        s["L"], s["V"], beam_size=M)
    sids, scores = r.retrieve(s["hist"], cids)
    np.testing.assert_array_equal(sids, want_sids)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-4)
    for b in range(s["B"]):
        members, live = compliance(
            np.unique(s["sets"][cids[b] if stacked else 1], axis=0),
            sids[b:b + 1], scores[b:b + 1])
        assert members == live > 0


def test_compressed_hot_swap_keeps_the_signature(retrieval, rng):
    s = retrieval
    store = s["store"]
    r = GenerativeRetriever(s["params"], s["cfg"],
                            DecodePolicy.stacked(store, compressed=True),
                            s["L"], s["V"], beam_size=4)
    before = _signature(r.policy)
    fresh_sids = make_sids(rng, 100, s["V"], s["L"])
    fresh = TransitionMatrix.from_sids(fresh_sids, s["V"], device="cpu")
    hot = store.with_member(0, fresh)
    assert r.set_constraints(hot) is False
    assert _signature(r.policy) == before
    slab = r.policy.backends[1].slab
    want = CompressedSlab.from_store(hot)
    assert torch.equal(slab.tok_delta, want.tok_delta)
    assert torch.equal(slab.level_base, want.level_base)
    sids, scores = r.retrieve(s["hist"], np.zeros(s["B"], np.int32))
    members, live = compliance(np.unique(fresh_sids, axis=0), sids, scores)
    assert members == live > 0
    single = GenerativeRetriever(
        s["params"], s["cfg"], DecodePolicy.static(store.member(1),
                                                   compressed=True),
        s["L"], s["V"])
    # another member has other real counts: a cold swap, with its own slab
    assert single.set_constraints(store.member(2)) is True
    assert torch.equal(single.policy.backends[1].slab.tok_delta,
                       CompressedSlab.from_matrix(store.member(2)).tok_delta)


# ---------------------------------------------------------------------------
# the memory model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dense_d", [0, 2])
def test_memory_model_matches_reference(corpus, dense_d):
    jtm, tm = _pair(corpus[0], V, dense_d)
    got = memory_model.measure(tm, CompressedSlab.from_matrix(tm))
    want = jax_memory_model.measure(jtm, JaxCompressedSlab.from_matrix(jtm))
    assert got == want
    assert memory_model.measure(tm) == jax_memory_model.measure(jtm)
    for args in ((2048, 5, 70), (32, 3, 4), (40000, 1, 100)):
        assert (memory_model.decode_step_traffic(*args)
                == jax_memory_model.decode_step_traffic(*args))
    for args in ((2048, 20_000_000, 8, 2), (40000, 10**6, 4, 1)):
        assert memory_model.u_max(*args) == jax_memory_model.u_max(*args)
        assert (memory_model.u_max_compressed(*args)
                == jax_memory_model.u_max_compressed(*args))
        for kw in (dict(compressed=True, hbm_budget=10**9), {}):
            assert (memory_model.plan_tiers(*args, **kw)
                    == jax_memory_model.plan_tiers(*args, **kw))
    assert (memory_model.capacity_rule_of_thumb(10**6)
            == jax_memory_model.capacity_rule_of_thumb(10**6))
