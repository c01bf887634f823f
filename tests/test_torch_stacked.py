"""Port multi-tenant (stacked ConstraintStore) path against the JAX reference.

The stacked references (the plain versions of the stacked CUDA kernels) are
held against the reference's stacked oracles and its stacked Pallas kernels
in interpret mode; the stacked dense lookups, policy guards, beam search
(the golden ``stacked`` trace and random mixed-id batches) and
``GenerativeRetriever.retrieve(history, constraint_ids)`` against the
reference package on the same inputs.  Integers and unfused scores are
equal; fused scores agree within rtol/atol 1e-5 (each side computes its own
log-sum-exp); model scores within 1e-4 (float32 matmul and reduction orders
differ between the frameworks).
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
from repro.core import dense_mask as jax_dense_mask
from repro.core.beam_search import beam_search as jax_beam_search
from repro.core.vntk import (
    vntk_stacked_reference_scatter as jax_stacked_scatter,
    vntk_stacked_topk_reference as jax_stacked_topk,
)
from repro.decoding import DecodePolicy as JaxDecodePolicy
from repro.kernels import ref
from repro.kernels.vntk import (
    vntk_stacked_fused_logsoftmax_pallas,
    vntk_stacked_pallas,
    vntk_stacked_topk_pallas,
)
from repro.models import transformer as jax_transformer
from repro.serving.generative_retrieval import (
    GenerativeRetriever as JaxGenerativeRetriever,
)
from repro_torch.configs.base import TransformerConfig
from repro_torch.constraints import ConstraintStore
from repro_torch.convert import params_from_jax, store_from_numpy
from repro_torch.core import TransitionMatrix
from repro_torch.core import dense_mask
from repro_torch.core.beam_search import beam_search
from repro_torch.core.vntk import (
    candidate_width,
    vntk_stacked_reference_scatter,
    vntk_stacked_topk_reference,
)
from repro_torch.decoding import (
    DecodePolicy,
    StackedStaticBackend,
    StaticBackend,
    as_policy,
)
from repro_torch.kernels import ops
from repro_torch.kernels import vntk as kv
from repro_torch.launch.serve import compliance
from repro_torch.serving import GenerativeRetriever

from conftest import make_sids
from test_torch_vntk import _check, _jax, _random_csr, _torch

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _stacked_case(rng, vocab, nb, bmax, K=3, n_states=24, scale=1.0,
                  ties=False, sink_share=0.25):
    """K random CSR members padded to one (K, S+1) / (K, E, 2) store; rows
    take mixed ids, a share of them at the sink."""
    rps, eds = zip(*(_random_csr(rng, n_states, vocab, bmax) for _ in range(K)))
    E = max(e.shape[0] for e in eds)
    edges = np.zeros((K, E, 2), np.int32)
    for k, e in enumerate(eds):
        edges[k, :e.shape[0]] = e
    nodes = rng.integers(1, n_states, nb).astype(np.int32)
    nodes[rng.random(nb) < sink_share] = 0
    cids = rng.integers(0, K, nb).astype(np.int32)
    x = (rng.normal(size=(nb, vocab)) * scale).astype(np.float32)
    if ties:  # see test_torch_vntk._case: + 0.0 folds -0.0 into +0.0
        x = np.round(x * 2) / 2 + 0.0
    return x, nodes, cids, np.stack(rps), edges


# ---------------------------------------------------------------------------
# rows 5-7: the stacked references against the stacked Pallas kernels
# ---------------------------------------------------------------------------
# nb 7 and 11 are prime
@pytest.mark.parametrize("vocab,nb,bmax,ties", [
    (128, 7, 9, False), (256, 11, 24, True), (256, 16, 1, False)])
@pytest.mark.parametrize("fused", [False, True])
def test_stacked_topk_matches_pallas(rng, vocab, nb, bmax, ties, fused):
    x, nodes, cids, rp, edges = _stacked_case(rng, vocab, nb, bmax,
                                              scale=4 if fused else 1,
                                              ties=ties)
    vals = x if fused else np.asarray(torch.log_softmax(torch.from_numpy(x),
                                                        -1))
    width = candidate_width(8, vocab)
    args = (bmax, vocab, width)
    want = vntk_stacked_topk_pallas(*_jax(vals, nodes, cids, rp, edges),
                                    *args, fused_logsoftmax=fused,
                                    interpret=True)
    oracle = ref.vntk_stacked_topk_ref(*_jax(vals, nodes, cids, rp, edges),
                                       *args, fused_logsoftmax=fused)
    got = kv.vntk_stacked_topk_plain(*_torch(vals, nodes, cids, rp, edges),
                                     *args, fused=fused)
    tol = dict(rtol=1e-5, atol=1e-5) if fused else dict(rtol=0)
    _check(got, want, **tol)
    _check(got, oracle, **tol)


@pytest.mark.parametrize("vocab,nb,bmax,ties", [
    (128, 7, 9, False), (256, 11, 24, True)])
@pytest.mark.parametrize("fused", [False, True])
def test_stacked_mask_matches_pallas(rng, vocab, nb, bmax, ties, fused):
    x, nodes, cids, rp, edges = _stacked_case(rng, vocab, nb, bmax,
                                              scale=4 if fused else 1,
                                              ties=ties)
    if fused:
        kernel, oracle_fn = (vntk_stacked_fused_logsoftmax_pallas,
                             ref.vntk_stacked_fused_logsoftmax_ref)
    else:
        kernel, oracle_fn = vntk_stacked_pallas, ref.vntk_stacked_ref
    want = kernel(*_jax(x, nodes, cids, rp, edges), bmax, vocab,
                  interpret=True)
    oracle = oracle_fn(*_jax(x, nodes, cids, rp, edges), bmax, vocab)
    got = kv.vntk_stacked_mask_plain(*_torch(x, nodes, cids, rp, edges), bmax,
                                     vocab, fused=fused)
    tol = dict(rtol=1e-5, atol=1e-5) if fused else dict(rtol=0)
    _check(got, want, **tol)
    _check(got, oracle, **tol)


def test_stacked_references_on_a_real_store(rng):
    """The core references on a ConstraintStore built by both packages, at
    a sparse level, mixed ids; 2-D (B, M) ids broadcast like the nodes."""
    vocab, length = 64, 5
    sets = [make_sids(rng, n, vocab, length, clustered=True)
            for n in (300, 800)]
    jstore = JaxConstraintStore.from_matrices(
        [JaxTransitionMatrix.from_sids(s, vocab, dense_d=2) for s in sets],
        headroom=0.5)
    store = store_from_numpy(jstore, device="cpu")
    B, M = 3, 4
    cids = rng.integers(0, 2, B).astype(np.int32)
    l1 = np.asarray(jstore.l1_states)
    prefixes = [sets[c][rng.integers(0, len(sets[c]), M)] for c in cids]
    nodes = np.stack([l1[c][p[:, 0], p[:, 1]] for c, p in zip(cids, prefixes)])
    nodes = nodes.astype(np.int32)
    lp = np.asarray(torch.log_softmax(torch.from_numpy(
        rng.normal(size=(B, M, vocab)).astype(np.float32)), -1))
    bmax = store.bmax_for_step(2)
    cids_bm = np.broadcast_to(cids[:, None], (B, M))
    tcids = torch.from_numpy(cids)[:, None].expand(B, M)
    got = vntk_stacked_reference_scatter(*_torch(lp, nodes), tcids,
                                         store.row_pointers, store.edges,
                                         bmax, vocab)
    want = jax_stacked_scatter(*_jax(lp, nodes, cids_bm), jstore.row_pointers,
                    jstore.edges, bmax, vocab)
    _check(got, want, rtol=0)
    got = vntk_stacked_topk_reference(*_torch(lp, nodes), tcids,
                                      store.row_pointers, store.edges, bmax,
                                      vocab, 8)
    want = jax_stacked_topk(*_jax(lp, nodes, cids_bm), jstore.row_pointers,
                 jstore.edges, bmax, vocab, 8)
    _check(got, want, rtol=0)


@pytest.mark.parametrize("dense_d", [1, 2])
def test_stacked_dense_lookups_match_reference(rng, dense_d):
    vocab, length = 40, 4
    sets = [make_sids(rng, n, vocab, length, clustered=True)
            for n in (200, 400)]
    jstore = JaxConstraintStore.from_matrices(
        [JaxTransitionMatrix.from_sids(s, vocab, dense_d=dense_d)
         for s in sets], headroom=0.2)
    store = store_from_numpy(jstore, device="cpu")
    lp = rng.normal(size=(3, 5, vocab)).astype(np.float32)
    cids = rng.integers(0, 2, (3, 5)).astype(np.int32)
    got = dense_mask.dense_lookup_l0(torch.from_numpy(lp), store,
                                     constraint_ids=torch.from_numpy(cids))
    want = jax_dense_mask.dense_lookup_l0(jnp.asarray(lp), jstore,
                                          constraint_ids=jnp.asarray(cids))
    _check(got, want, rtol=0)
    if dense_d == 2:
        nodes = np.stack([[np.asarray(jstore.l0_states)[c, sets[c][
            rng.integers(0, len(sets[c])), 0]] for c in row] for row in cids])
        nodes = nodes.astype(np.int32)
        nodes[0, 0] = 0  # a sink parent has no continuation
        got = dense_mask.dense_lookup_l1(*_torch(lp, nodes), store,
                                         constraint_ids=torch.from_numpy(cids))
        want = jax_dense_mask.dense_lookup_l1(*_jax(lp, nodes), jstore,
                                              constraint_ids=jnp.asarray(cids))
        _check(got, want, rtol=0)


# ---------------------------------------------------------------------------
# dispatch and guards
# ---------------------------------------------------------------------------
def test_cpu_stacked_routes_to_the_plain_versions(rng):
    x, nodes, cids, rp, edges = _stacked_case(rng, 64, 6, 8)
    lp = torch.log_softmax(torch.from_numpy(x), -1)
    t_nodes, t_cids, t_rp, t_edges = _torch(nodes, cids, rp, edges)
    before = dict(kv.LAUNCHES)
    for fused in (False, True):
        got = ops.vntk_topk(lp.reshape(2, 3, 64), t_nodes.reshape(2, 3),
                            t_rp, t_edges, 8, 64, 8, fused_logsoftmax=fused,
                            constraint_ids=t_cids.reshape(2, 3))
        want = kv.vntk_stacked_topk_plain(lp, t_nodes, t_cids, t_rp, t_edges,
                                          8, 64, 8, fused)
        for g, w in zip(got, want):
            assert torch.equal(g.reshape(w.shape), w)
    masked, nxt = ops.vntk(lp, t_nodes, t_rp, t_edges, 8, 64,
                           constraint_ids=t_cids)
    want = kv.vntk_stacked_mask_plain(lp, t_nodes, t_cids, t_rp, t_edges, 8,
                                      64)
    assert torch.equal(masked, want[0]) and torch.equal(nxt, want[1])
    _, fn = ops.vntk_fused_logsoftmax(lp, t_nodes, t_rp, t_edges, 8, 64,
                                      impl="plain", constraint_ids=t_cids)
    assert torch.equal(fn, nxt)
    assert kv.LAUNCHES == before  # no kernel launched on CPU tensors
    assert {"vntk_stacked_topk", "vntk_stacked_topk_fused",
            "vntk_stacked_mask", "vntk_stacked_mask_fused"} <= set(kv.LAUNCHES)


def test_stacked_kernel_wrappers_reject_cpu_tensors(rng):
    x, nodes, cids, rp, edges = _stacked_case(rng, 64, 4, 8)
    args = _torch(x, nodes, cids, rp, edges)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kv.vntk_stacked_topk_cuda(*args, 8, 64, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kv.vntk_stacked_mask_cuda(*args, 8, 64, fused=True)


@pytest.fixture(scope="module")
def golden():
    inputs = np.load(GOLDEN / "inputs.npz")
    tm = TransitionMatrix.load(GOLDEN / "trie_small.npz", device="cpu")
    V = inputs["table"].shape[-1]
    decoy = TransitionMatrix.from_sids(inputs["decoy"], V, dense_d=2,
                                       device="cpu")
    store = ConstraintStore.from_matrices([decoy, tm], headroom=0.2,
                                          device="cpu")
    return inputs, np.load(GOLDEN / "traces.npz"), tm, store


def test_policy_guards_and_plan(golden):
    _, _, tm, store = golden
    V, L = store.vocab_size, store.sid_length
    policy = as_policy(store)
    assert policy.requires_constraint_ids and policy.num_sets == 2
    assert policy.constraints is store
    assert DecodePolicy.static(store).describe() == policy.describe() == (
        "L0-1:stacked(K=2):dense-bitpack L2-3:stacked(K=2):vntk[auto+topk]")
    assert DecodePolicy.stacked(store, fused=True, topk=False,
                                impl="plain").describe() == (
        "L0-1:stacked(K=2):dense-bitpack L2-3:stacked(K=2):vntk[plain+fused]")
    single = DecodePolicy.static(tm)
    assert not single.requires_constraint_ids and single.num_sets is None
    logits = torch.zeros(2, V)
    nodes = torch.ones(2, dtype=torch.int32)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="constraint_ids"):
        policy.step(logits, nodes, 0)  # a store without ids
    with pytest.raises(ValueError, match="constraint_ids"):
        policy.step_topk(logits, nodes, 2, 8)
    with pytest.raises(ValueError, match="stacked ConstraintStore policy"):
        single.step(logits, nodes, 0, constraint_ids=ids)
    with pytest.raises(ValueError, match="stacked ConstraintStore backend"):
        StaticBackend(tm).mask_step(logits, nodes, 0, constraint_ids=ids)
    with pytest.raises(ValueError, match="impl"):
        StackedStaticBackend(store, impl="pallas")
    table = lambda c, last, step: (torch.zeros(2, 4, V), c)  # noqa: E731
    with pytest.raises(ValueError, match="per-row constraint_ids"):
        beam_search(table, None, 2, 4, L, policy)
    with pytest.raises(ValueError, match="stacked ConstraintStore policy"):
        beam_search(table, None, 2, 4, L, single, constraint_ids=ids)
    with pytest.raises(TypeError, match="no swappable backend"):
        single.with_constraints(store)


@pytest.mark.parametrize("topk", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_golden_stacked_trace_step_by_step(golden, topk, fused):
    """Every row on member 1 of ``[decoy, tm]`` at headroom 0.2, as
    ``tests/golden/regenerate.py`` generated it (dense advance)."""
    inputs, traces, _, store = golden
    table = torch.from_numpy(inputs["table"])
    B, M, L = 2, 4, store.sid_length

    def logits_fn(carry, last, step):
        return table[step][last.long()], carry

    policy = DecodePolicy.stacked(store, fused=fused, topk=topk)
    state, _, trace = beam_search(logits_fn, None, B, M, L, policy,
                                  constraint_ids=np.ones(B, np.int32),
                                  return_trace=True)
    tol = dict(rtol=1e-5, atol=1e-5) if fused else dict(rtol=1e-6)
    for step in range(L):
        np.testing.assert_array_equal(
            trace.tokens[step].numpy(), traces["stacked_trace_tokens"][step],
            err_msg=f"beams diverged first at decode step {step}")
        np.testing.assert_allclose(trace.scores[step].numpy(),
                                   traces["stacked_trace_scores"][step], **tol)
    np.testing.assert_array_equal(state.tokens.numpy(),
                                  traces["stacked_tokens"])


@pytest.mark.parametrize("topk", [True, False])
def test_mixed_id_beam_search_matches_reference(rng, topk):
    V, L, B, M = 24, 4, 5, 6
    sets = [make_sids(rng, n, V, L, clustered=True) for n in (30, 200, 90)]
    jstore = JaxConstraintStore.from_matrices(
        [JaxTransitionMatrix.from_sids(s, V, dense_d=2) for s in sets],
        headroom=0.3)
    store = store_from_numpy(jstore, device="cpu")
    table = rng.normal(size=(L, V, V)).astype(np.float32)
    cids = np.array([2, 0, 1, 1, 0], np.int32)

    def jfn(carry, last, step):
        return jnp.asarray(table)[step][last], carry

    def tfn(carry, last, step):
        return torch.from_numpy(table)[step][last.long()], carry

    want, _ = jax_beam_search(jfn, None, B, M, L,
                              JaxDecodePolicy.stacked(jstore).with_topk(topk),
                              constraint_ids=jnp.asarray(cids))
    got, _ = beam_search(tfn, None, B, M, L,
                         DecodePolicy.stacked(store, topk=topk),
                         constraint_ids=torch.from_numpy(cids))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    for b, c in enumerate(cids):
        members, live = compliance(np.unique(sets[c], axis=0),
                                   got.tokens.numpy()[b:b + 1],
                                   got.scores.numpy()[b:b + 1])
        assert members == live > 0


# ---------------------------------------------------------------------------
# the retriever
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def retrieval():
    V, L, B, S = 32, 4, 3, 10
    jcfg = JaxTransformerConfig(
        name="gr-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=34, dtype="float32", tie_embeddings=True,
        attn_chunk_q=8)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(5)
    sets = [make_sids(rng, n, V, L) for n in (60, 400, 150)]
    jmats = [JaxTransitionMatrix.from_sids(s, V, dense_d=2) for s in sets]
    jstore = JaxConstraintStore.from_matrices(jmats, headroom=0.5)
    jparams = jax_transformer.init_params(jcfg, jax.random.key(5))
    return dict(
        V=V, L=L, B=B, jcfg=jcfg, cfg=cfg, sets=sets, jmats=jmats,
        jstore=jstore, store=store_from_numpy(jstore, device="cpu"),
        jparams=jparams, hist=rng.integers(0, jcfg.vocab_size, (B, S)),
        params=params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu"))


@pytest.mark.parametrize("kw", [{}, dict(topk=False)])
def test_retrieve_with_mixed_ids_matches_reference(retrieval, kw):
    s, M = retrieval, 5
    cids = np.array([1, 2, 0], np.int32)
    want_sids, want_scores = JaxGenerativeRetriever(
        s["jparams"], s["jcfg"], JaxDecodePolicy.stacked(s["jstore"], **kw),
        s["L"], s["V"], beam_size=M).retrieve(s["hist"], cids)
    r = GenerativeRetriever(s["params"], s["cfg"],
                            DecodePolicy.stacked(s["store"], **kw), s["L"],
                            s["V"], beam_size=M)
    assert r.num_sets == 3 and r.constraints is s["store"]
    sids, scores = r.retrieve(s["hist"], cids)
    np.testing.assert_array_equal(sids, want_sids)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-4)
    for b, c in enumerate(cids):  # each row's beams lie in its own set
        members, live = compliance(np.unique(s["sets"][c], axis=0),
                                   sids[b:b + 1], scores[b:b + 1])
        assert members == live > 0
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        r.retrieve(s["hist"], np.array([0, 3, 1], np.int32))
    with pytest.raises(ValueError, match="constraint_ids"):
        r.retrieve(s["hist"])


def test_set_constraints_hot_and_cold(retrieval, rng):
    s = retrieval
    store = s["store"]
    r = GenerativeRetriever(s["params"], s["cfg"], store, s["L"], s["V"],
                            beam_size=4)
    fresh_sids = make_sids(rng, 100, s["V"], s["L"])
    fresh = TransitionMatrix.from_sids(fresh_sids, s["V"], device="cpu")
    hot = store.with_member(0, fresh)
    assert r.set_constraints(hot) is False  # same shapes and static fields
    assert r.constraints is hot
    sids, scores = r.retrieve(s["hist"], np.zeros(s["B"], np.int32))
    members, live = compliance(np.unique(fresh_sids, axis=0), sids, scores)
    assert members == live > 0
    regrown = ConstraintStore.from_matrices(
        [store.member(k) for k in range(3)] + [fresh], device="cpu")
    assert r.set_constraints(regrown) is True  # num_sets and envelope moved
    single = GenerativeRetriever(s["params"], s["cfg"], fresh, s["L"], s["V"])
    assert single.num_sets is None
    assert single.set_constraints(fresh) is False
    assert single.set_constraints(store.member(1)) is True  # other shapes

