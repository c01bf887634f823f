"""The port's SPMD serving stack in a world of one rank (gloo, CPU).

The contracts of the reference's ``tests/test_spmd_serving.py`` (each test
names its counterpart), the padding fuzz of
``tests/test_differential_fuzz.py`` and the SPMD cold swap of
``tests/test_refresh.py``, on a ``(1, 1)`` mesh where every collective is
the identity:

  * ``pad_rows``/``pad_slab``/``pad_policy_rows`` arrays equal to the
    reference's, at shard counts that do not divide the edge count;
  * ``policy_pspecs`` equal to the reference's leaf for leaf, for single,
    stacked, compressed and baseline policies;
  * ``spmd_beam_search`` on table logits: tokens equal to the reference's
    ``beam_search`` and scores within the golden traces' 1e-6, tokens and
    scores bit-equal to the port's single-device search;
  * ``SpmdRetriever`` on ``smoke_config("stablelm-12b")`` with the
    reference's weights: SIDs equal to the reference's single-device
    ``GenerativeRetriever`` and scores within 1e-4 (float32 matmul orders
    differ between the frameworks), and bit-equal to the port's own
    ``GenerativeRetriever``, for both placements;
  * the active mask, hot and cold swaps counted as 0 and 1 specializations,
    the engine's mixed queue at full compliance, the refusals, and the
    launcher's ``--engine spmd``.

Worlds of more ranks are in ``tests/test_torch_spmd_multiproc.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import smoke_config as jax_smoke_config
from repro.constraints import ConstraintStore as JaxStore
from repro.core import TransitionMatrix as JaxTM
from repro.core import beam_search as jax_beam_search
from repro.decoding import DecodePolicy as JaxPolicy
from repro.distributed import constraint_sharding as jcs
from repro.models import transformer as jax_transformer
from repro.serving.generative_retrieval import (
    GenerativeRetriever as JaxRetriever,
)
from repro_torch.configs.base import TransformerConfig
from repro_torch.constraints import (
    CatalogDelta,
    ConstraintRegistry,
    ConstraintStore,
    ItemCatalog,
    category_allowlist,
    freshness_window,
)
from repro_torch.convert import params_from_jax
from repro_torch.core import TransitionMatrix
from repro_torch.core.beam_search import beam_search
from repro_torch.core.vntk import NEG_INF
from repro_torch.decoding import DecodePolicy
from repro_torch.distributed import constraint_sharding as cs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.observability import compile_events
from repro_torch.serving import GenerativeRetriever, RequestQueue
from repro_torch.serving.spmd_engine import SpmdRetriever, SpmdServingEngine
from conftest import make_sids
from test_differential_fuzz import FUZZ_SEEDS, make_case

V, L = 16, 4


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) mesh in a world of one, destroyed after the module."""
    with mesh_lib.world("cpu"):
        yield mesh_lib.make_debug_mesh(model=2)


@pytest.fixture(scope="module")
def small_lm():
    jcfg = jax_smoke_config("stablelm-12b")
    jparams = jax_transformer.init_params(jcfg, jax.random.key(0))
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jparams, jcfg, params, cfg


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    sids = np.unique(make_sids(rng, 150, V, L, clustered=True), axis=0)
    table = rng.normal(size=(L, V, V)).astype(np.float32)
    return sids, table


def test_world_of_one_and_its_meshes(mesh):
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh_lib.init_world("cpu") is False  # joins, does not recreate
    assert tuple(mesh_lib.make_subset_mesh(1, 1).shape) == (1, 1)
    with pytest.raises(ValueError, match="subset mesh needs 2 ranks"):
        mesh_lib.make_subset_mesh(2, 1)


# ---------------------------------------------------------------------------
# padding and placement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [3, 5, 7])
@pytest.mark.parametrize("seed", FUZZ_SEEDS[:3])
def test_pad_policy_rows_equals_reference(seed, n_shards):
    """``test_fuzz_pad_rows_nondividing_with_compressed_slab``: padded
    edges and deltas equal the reference's; static fields unchanged; a
    second padding is a no-op."""
    case = make_case(seed)
    sids, cv, d = case["sids"], case["V"], case["dense_d"]
    tm = TransitionMatrix.from_sids(sids, cv, dense_d=d, device="cpu")
    if tm.edges.shape[0] % n_shards == 0:
        n_shards += 1  # force a real pad
    want = jcs.pad_policy_rows(
        JaxPolicy.static(JaxTM.from_sids(sids, cv, dense_d=d),
                         compressed=True), n_shards)
    got = cs.pad_policy_rows(
        DecodePolicy.static(tm, compressed=True), n_shards)
    for g, w in zip(got.backends, want.backends):
        np.testing.assert_array_equal(g.tm.edges.numpy(),
                                      np.asarray(w.tm.edges))
        assert g.tm.edges.shape[0] % n_shards == 0
        assert g.tm.edges.shape[0] > tm.edges.shape[0]
        assert g.tm.n_edges == tm.n_edges
        if w.slab is not None:
            np.testing.assert_array_equal(g.slab.tok_delta.numpy(),
                                          np.asarray(w.slab.tok_delta))
    again = cs.pad_policy_rows(got, n_shards)
    assert all(a.tm.edges is g.tm.edges
               for a, g in zip(again.backends, got.backends))
    assert cs.pad_rows(tm, 1) is tm and cs.pad_slab(None, 3) is None
    # one padded copy for the matrix the dense and sparse backends share
    if len(got.backends) == 2:
        assert got.backends[0].tm is got.backends[1].tm


def test_pad_rows_of_a_store_pads_axis_1(corpus):
    sids, _ = corpus
    tms = [TransitionMatrix.from_sids(sids[i::2], V, device="cpu")
           for i in range(2)]
    store = ConstraintStore.from_matrices(tms, headroom=0.1, device="cpu")
    padded = cs.pad_rows(store, 7)
    assert padded.edges.shape[1] % 7 == 0
    assert padded.edges.shape[0] == store.num_sets
    np.testing.assert_array_equal(
        padded.edges[:, :store.edges.shape[1]].numpy(), store.edges.numpy())
    assert not padded.edges[:, store.edges.shape[1]:].any()


def _jax_spec_leaves(specs) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(path): tuple(s) for path, s in leaves}


def _port_spec_leaves(spec, obj, path="") -> dict:
    """{path: spec} at every tensor of ``obj``, paths as ``keystr``."""
    if isinstance(obj, torch.Tensor):
        return {path: spec}
    out = {}
    if isinstance(obj, tuple):
        for i, (s, x) in enumerate(zip(spec, obj)):
            out.update(_port_spec_leaves(s, x, f"{path}[{i}]"))
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_port_spec_leaves(getattr(spec, f.name),
                                         getattr(obj, f.name),
                                         f"{path}.{f.name}"))
    return out


def _policy_pairs(sids):
    jtm = JaxTM.from_sids(sids, V)
    tm = TransitionMatrix.from_sids(sids, V, device="cpu")
    jst = JaxStore.from_matrices([jtm, jtm], headroom=0.1)
    st = ConstraintStore.from_matrices([tm, tm], headroom=0.1, device="cpu")
    return {
        "static": (JaxPolicy.static(jtm), DecodePolicy.static(tm)),
        "stacked": (JaxPolicy.stacked(jst), DecodePolicy.stacked(st)),
        "compressed": (JaxPolicy.static(jtm, compressed=True),
                       DecodePolicy.static(tm, compressed=True)),
        "stacked_compressed": (JaxPolicy.stacked(jst, compressed=True),
                               DecodePolicy.stacked(st, compressed=True)),
        "ppv": (JaxPolicy.ppv(sids, V),
                DecodePolicy.ppv(sids, V, device="cpu")),
        "hash_bitmap": (JaxPolicy.hash_bitmap(sids, V, log2_bits=12),
                        DecodePolicy.hash_bitmap(sids, V, log2_bits=12,
                                                 device="cpu")),
        "unconstrained": (JaxPolicy.unconstrained(),
                          DecodePolicy.unconstrained()),
    }


@pytest.mark.parametrize("rows", ["replicated", "model"])
@pytest.mark.parametrize("name", ["static", "stacked", "compressed",
                                  "stacked_compressed", "ppv", "hash_bitmap",
                                  "unconstrained"])
def test_policy_pspecs_equal_reference(corpus, name, rows):
    """``test_policy_pspecs_structure``, leaf for leaf."""
    sids, _ = corpus
    jpol, pol = _policy_pairs(sids)[name]
    jmesh = jax.sharding.AbstractMesh((1, 2), ("data", "model"))
    want = _jax_spec_leaves(jcs.policy_pspecs(jpol, jmesh, rows=rows))
    got = _port_spec_leaves(cs.policy_pspecs(
        pol, mesh_lib.MeshSpec((1, 2), ("data", "model")), rows=rows), pol)
    assert got == want
    if rows == "model" and name in ("static", "stacked"):
        assert any("model" in s for s in got.values())
    with pytest.raises(ValueError, match="rows"):
        cs.policy_pspecs(pol, mesh_lib.MeshSpec((1, 2), ("data", "model")),
                         rows="banana")


def test_shard_tensor_places_by_spec(mesh):
    from repro_torch.distributed.sharding import placements, shard_tensor

    t = torch.arange(12.0).reshape(6, 2)
    d = shard_tensor(t, ("model", None), mesh)
    assert tuple(d.placements) == placements(("model", None), mesh)
    assert torch.equal(d.to_local(), t)  # one rank holds every row


def test_shard_policy_on_one_rank_keeps_every_table(mesh, corpus):
    sids, _ = corpus
    pol = DecodePolicy.static(
        TransitionMatrix.from_sids(sids, V, device="cpu"), impl="plain")
    cut = cs.shard_policy(cs.pad_policy_rows(pol, 1), mesh, rows="model")
    assert cut.backends[1].tm.edges is pol.backends[1].tm.edges


def test_row_sharded_rejects_kernels_and_fused(small_lm, mesh, rng):
    """``test_row_sharded_rejects_pallas_and_fused``: the row-sharded step
    is plain torch; a policy that asks for the CUDA kernels (``impl=None``)
    or the fused step is refused, not quietly served by plain code."""
    _, _, params, cfg = small_lm
    tm = TransitionMatrix.from_sids(make_sids(rng, 40, cfg.vocab_size, L),
                                    cfg.vocab_size, device="cpu")
    for bad in (DecodePolicy.static(tm, impl="plain", fused=True),
                DecodePolicy.static(tm)):
        with pytest.raises(ValueError, match="impl='plain'"):
            SpmdRetriever(params, cfg, bad, L, cfg.vocab_size, beam_size=4,
                          mesh=mesh, rows="model")
        with pytest.raises(ValueError, match="rows='model'"):
            cs.to_row_sharded(bad)


# ---------------------------------------------------------------------------
# spmd_beam_search
# ---------------------------------------------------------------------------
def _searches(table, B, M, policy, jpolicy, cids=None):
    jt, tt = jnp.asarray(table), torch.as_tensor(table)

    @jax.jit
    def single(pol, ids):
        state, _ = jax_beam_search(lambda c, last, s: (jt[s][last], c), None,
                                   B, M, L, pol, constraint_ids=ids)
        return state.tokens, state.scores

    wt, ws = single(jpolicy, None if cids is None else jnp.asarray(cids))

    def logits_fn(c, last, s):
        return tt[s][last.long()], c

    state, _ = beam_search(logits_fn, None, B, M, L, policy,
                           constraint_ids=cids)
    return logits_fn, np.asarray(wt), np.asarray(ws), state


@pytest.mark.parametrize("rows", ["replicated", "model"])
def test_spmd_beam_search_bit_identical(mesh, corpus, rows):
    sids, table = corpus
    B = 2 * cs.dp_size(mesh)
    pol = DecodePolicy.static(
        TransitionMatrix.from_sids(sids, V, dense_d=2, device="cpu"),
        impl="plain")
    fn, wt, ws, state = _searches(
        table, B, 5, pol, JaxPolicy.static(JaxTM.from_sids(sids, V)))
    tokens, scores = cs.spmd_beam_search(mesh, fn, B, 5, L, pol, rows=rows)
    np.testing.assert_array_equal(tokens.numpy(), wt)
    np.testing.assert_allclose(scores.numpy(), ws, rtol=1e-6)
    assert torch.equal(tokens, state.tokens)
    assert torch.equal(scores, state.scores)


def test_spmd_beam_search_stacked_constraint_ids(mesh, corpus, rng):
    sids, table = corpus
    sids2 = make_sids(rng, 60, V, L, clustered=True)
    jst = JaxStore.from_matrices(
        [JaxTM.from_sids(sids, V), JaxTM.from_sids(sids2, V)], headroom=0.25)
    st = ConstraintStore.from_matrices(
        [TransitionMatrix.from_sids(sids, V, device="cpu"),
         TransitionMatrix.from_sids(sids2, V, device="cpu")], headroom=0.25,
        device="cpu")
    B = 2 * cs.dp_size(mesh)
    cids = np.arange(B, dtype=np.int32) % 2
    pol = DecodePolicy.stacked(st)
    fn, wt, ws, state = _searches(table, B, 4, pol, JaxPolicy.stacked(jst),
                                  cids)
    tokens, scores = cs.spmd_beam_search(mesh, fn, B, 4, L, pol,
                                         constraint_ids=cids)
    np.testing.assert_array_equal(tokens.numpy(), wt)
    np.testing.assert_allclose(scores.numpy(), ws, rtol=1e-6)
    assert torch.equal(tokens, state.tokens)
    assert torch.equal(scores, state.scores)


def test_spmd_beam_search_caches_the_rank_policy(mesh, corpus):
    sids, table = corpus
    pol = DecodePolicy.static(
        TransitionMatrix.from_sids(sids, V, device="cpu"), impl="plain")
    tt = torch.as_tensor(table)

    def fn(c, last, s):
        return tt[s][last.long()], c

    cs.spmd_beam_search(mesh, fn, 2, 4, L, pol, rows="model")
    hits = [v for k, v in cs._SPMD_SEARCH_CACHE.items() if k[1] is fn]
    assert len(hits) == 1 and hits[0][0] is pol
    local = hits[0][1]
    cs.spmd_beam_search(mesh, fn, 2, 4, L, pol, rows="model")
    assert [v for k, v in cs._SPMD_SEARCH_CACHE.items()
            if k[1] is fn][0][1] is local  # not re-cut
    pol2 = pol.with_constraints(
        TransitionMatrix.from_sids(sids[::-1].copy(), V, device="cpu"))
    cs.spmd_beam_search(mesh, fn, 2, 4, L, pol2, rows="model")
    assert [v for k, v in cs._SPMD_SEARCH_CACHE.items()
            if k[1] is fn][0][0] is pol2  # a swapped policy is re-cut


def test_spmd_beam_search_rejects_ragged_batch(corpus):
    sids, table = corpus
    pol = DecodePolicy.static(
        TransitionMatrix.from_sids(sids, V, device="cpu"))
    two_way = mesh_lib.MeshSpec((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="pad with inactive rows"):
        cs.spmd_beam_search(two_way, None, 3, 4, L, pol)


# ---------------------------------------------------------------------------
# SpmdRetriever
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows", ["replicated", "model"])
def test_spmd_retriever_matches_single_device(small_lm, mesh, rng, rows):
    jparams, jcfg, params, cfg = small_lm
    Vm, Lm = cfg.vocab_size, 4
    sids = make_sids(rng, 80, Vm, Lm, clustered=True)
    B = cs.dp_size(mesh) + 1
    hist = rng.integers(0, Vm, (B, 8)).astype(np.int32)
    want_t, want_s = JaxRetriever(jparams, jcfg, JaxTM.from_sids(sids, Vm),
                                  sid_length=Lm, sid_vocab=Vm,
                                  beam_size=4).retrieve(hist)
    pol = DecodePolicy.static(TransitionMatrix.from_sids(sids, Vm,
                                                         device="cpu"),
                              impl="plain" if rows == "model" else None)
    got_t, got_s = SpmdRetriever(params, cfg, pol, Lm, Vm, beam_size=4,
                                 mesh=mesh, rows=rows).retrieve(hist)
    assert got_t.shape == (B, 4, Lm)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-4)
    own_t, own_s = GenerativeRetriever(params, cfg, pol, Lm, Vm,
                                       beam_size=4).retrieve(hist)
    np.testing.assert_array_equal(got_t, own_t)
    np.testing.assert_array_equal(got_s, own_s)


def test_spmd_retriever_active_mask(small_lm, mesh, rng):
    _, _, params, cfg = small_lm
    Vm, Lm = cfg.vocab_size, 3
    tm = TransitionMatrix.from_sids(make_sids(rng, 50, Vm, Lm), Vm,
                                    device="cpu")
    B = 2 * cs.dp_size(mesh)
    hist = rng.integers(0, Vm, (B, 8)).astype(np.int32)
    active = np.ones(B, bool)
    active[0] = False
    retr = SpmdRetriever(params, cfg, tm, sid_length=Lm, sid_vocab=Vm,
                         beam_size=4, mesh=mesh)
    _, scores = retr.retrieve(hist, active_mask=active)
    assert (scores[0] <= NEG_INF).all()  # free slot: parked, unmistakable
    assert (scores[1:, 0] > NEG_INF / 2).all()


def _catalog(rng, n, Vm, Lm):
    sids = np.unique(make_sids(rng, n, Vm, Lm, clustered=True), axis=0)
    m = sids.shape[0]
    return ItemCatalog(sids=sids, age_days=rng.uniform(0, 60, m),
                       category=rng.integers(0, 4, m))


@pytest.mark.parametrize("rows", ["replicated", "model"])
def test_spmd_hot_swap_zero_specializations_under_mesh(small_lm, mesh, rng,
                                                       rows):
    """``test_spmd_hot_swap_zero_recompile_under_mesh``: a registry hot
    swap counts no new specialization of the retrieve."""
    _, _, params, cfg = small_lm
    Vm, Lm = cfg.vocab_size, 4
    reg = ConstraintRegistry(Vm, headroom=0.5, device="cpu")
    reg.register("fresh_20", freshness_window(20))
    reg.register("fresh_45", freshness_window(45))
    store = reg.build(_catalog(rng, 200, Vm, Lm))
    retr = SpmdRetriever(params, cfg, DecodePolicy.stacked(store,
                                                           impl="plain"),
                         Lm, Vm, beam_size=4, mesh=mesh, rows=rows)
    eng = SpmdServingEngine(retr, registry=reg, slots=4, prompt_width=8)
    q = RequestQueue()
    for i in range(5):
        q.submit(rng.integers(0, Vm, (8,)), n_tokens=Lm, constraint_id=i % 2)
    r1 = eng.serve(q)
    assert all(r["store_version"] == 1 for r in r1.values())
    assert reg.swap(_catalog(rng, 220, Vm, Lm)) == 2
    c0 = compile_events()
    for i in range(3):
        q.submit(rng.integers(0, Vm, (8,)), n_tokens=Lm, constraint_id=i % 2)
    r2 = eng.serve(q)
    assert compile_events() == c0, "mesh hot swap specialized anew"
    assert all(r["store_version"] == 2 for r in r2.values())
    assert eng.cold_swaps == 0
    # the first install of version 1 and the swap to version 2
    assert eng.metrics.counter("serving_hot_swaps_total").total() == 2


def test_spmd_metadata_changing_swap_rebuilds(small_lm, mesh, rng):
    """A swap outside the envelope is cold: one specialization, then the
    retrieve serves the new matrix."""
    _, _, params, cfg = small_lm
    Vm, Lm = cfg.vocab_size, 3
    tm1 = TransitionMatrix.from_sids(make_sids(rng, 40, Vm, Lm), Vm,
                                     device="cpu")
    tm2 = TransitionMatrix.from_sids(make_sids(rng, 90, Vm, Lm), Vm,
                                     device="cpu")
    assert tm1.n_states != tm2.n_states
    retr = SpmdRetriever(params, cfg, DecodePolicy.static(tm1, impl="plain"),
                         Lm, Vm, beam_size=4, mesh=mesh, rows="model")
    hist = rng.integers(0, Vm, (cs.dp_size(mesh), 8)).astype(np.int32)
    retr.retrieve(hist)
    assert retr.set_constraints(tm2) is True
    c0 = compile_events()
    _, scores = retr.retrieve(hist)
    assert compile_events() == c0 + 1
    assert (scores[:, 0] > NEG_INF / 2).all()
    assert retr.constraints.n_states == tm2.n_states


def test_spmd_engine_mixed_queue_compliance(small_lm, mesh, rng):
    """Continuous batching drains a mixed-constraint queue larger than the
    slot count, each row compliant with ITS OWN set; an out-of-range id is
    rejected alone."""
    _, _, params, cfg = small_lm
    Vm, Lm = cfg.vocab_size, 4
    cat = _catalog(rng, 250, Vm, Lm)
    reg = ConstraintRegistry(Vm, headroom=0.4, device="cpu")
    preds = {
        reg.register("fresh_25", freshness_window(25)): freshness_window(25),
        reg.register("fresh_50", freshness_window(50)): freshness_window(50),
    }
    retr = SpmdRetriever(params, cfg, reg.build(cat), Lm, Vm, beam_size=4,
                         mesh=mesh)
    eng = SpmdServingEngine(retr, registry=reg, slots=4, prompt_width=8)
    q = RequestQueue()
    rids = [q.submit(rng.integers(0, Vm, (8,)), n_tokens=Lm,
                     constraint_id=i % 2) for i in range(9)]
    results = eng.serve(q)
    assert set(results) == set(rids) and len(q) == 0
    alive = 0
    for r in results.values():
        valid = {tuple(x) for x in cat.sids[preds[r["constraint_id"]](cat)]}
        for m, sid in enumerate(r["sids"]):
            if r["scores"][m] > NEG_INF / 2:
                alive += 1
                assert tuple(sid) in valid, (r["constraint_id"], sid)
    assert alive > 0
    bad = q.submit(rng.integers(0, Vm, (8,)), n_tokens=Lm, constraint_id=77)
    ok = q.submit(rng.integers(0, Vm, (8,)), n_tokens=Lm, constraint_id=1)
    res = eng.serve(q)
    assert "constraint_id 77" in res[bad]["error"] and "sids" not in res[bad]
    assert res[ok]["scores"][0] > NEG_INF / 2 and len(q) == 0
    assert eng.slots == 4


def test_spmd_retriever_rejects_cpu_trie(small_lm, mesh, rng):
    _, _, params, cfg = small_lm
    sids = make_sids(rng, 30, cfg.vocab_size, 3)
    with pytest.raises(TypeError, match="CpuTrieBackend"):
        SpmdRetriever(params, cfg,
                      DecodePolicy.cpu_trie(sids, cfg.vocab_size),
                      3, cfg.vocab_size, mesh=mesh)
    with pytest.raises(ValueError, match="rows must be"):
        SpmdRetriever(params, cfg, None, 3, cfg.vocab_size, mesh=mesh,
                      rows="banana")


def test_spmd_engine_cold_swap_rebuilds_once_and_drains(small_lm, mesh, rng):
    """``tests/test_refresh.py``'s SPMD cold swap: a hot delta counts no
    specialization, a delta that outgrows the envelope exactly one, and
    the queue drains."""
    _, _, params, cfg = small_lm
    Vm, Lm = cfg.vocab_size, 4
    cat = _catalog(rng, 80, Vm, Lm)
    reg = ConstraintRegistry(Vm, headroom=0.5, device="cpu")
    reg.register("fresh", freshness_window(45))
    reg.register("cats", category_allowlist(0, 1, 2))
    store = reg.build(cat)
    retr = SpmdRetriever(params, cfg, DecodePolicy.stacked(store), Lm, Vm,
                         beam_size=4, mesh=mesh)
    eng = SpmdServingEngine(retr, registry=reg, slots=4, prompt_width=8)
    q = RequestQueue()
    for i in range(4):
        q.submit(rng.integers(0, Vm, (8,)), n_tokens=Lm, constraint_id=i % 2)
    eng.serve(q)
    rm = cat.sids[rng.choice(cat.sids.shape[0], 10, replace=False)]
    seen = {tuple(r) for r in cat.sids}
    add = _catalog(rng, 10, Vm, Lm)
    add = add.select(np.array([tuple(r) not in seen for r in add.sids]))
    reg.swap_delta(CatalogDelta(added=add, removed_sids=rm))
    c0 = compile_events()
    q.submit(rng.integers(0, Vm, (8,)), n_tokens=Lm)
    eng.serve(q)
    assert compile_events() == c0 and eng.cold_swaps == 0
    reg.swap_delta(CatalogDelta(added=_catalog(rng, 1500, Vm, Lm)))
    c0 = compile_events()
    rids = [q.submit(rng.integers(0, Vm, (8,)), n_tokens=Lm,
                     constraint_id=i % 2) for i in range(5)]
    results = eng.serve(q)
    assert set(rids) <= set(results) and len(q) == 0
    assert eng.cold_swaps == 1
    assert compile_events() == c0 + 1


@pytest.mark.parametrize("rows", ["replicated", "model"])
def test_launcher_serves_spmd(mesh, rows):
    """``launch.serve --engine spmd`` joins the world that exists and
    serves; every beam is in the constraint set."""
    argv = ["--config", "small", "--constraints", "300", "--batch", "2",
            "--beam", "4", "--requests", "1", "--device", "cpu",
            "--engine", "spmd", "--spmd-rows", rows]
    assert serve.main(argv) == 0
    assert serve.main(argv[:-4] + ["--spmd"]) == 0
