"""Port continuous-batching engine against the JAX reference and the port's
own batch engine.

  * ``PagedKVAllocator``, ``PrefixShareTable`` and ``StepScheduler`` hold the
    reference classes' state step by step under the same operations;
  * the paged pools' ``scatter_pages``/``gather_pages`` equal the
    reference's;
  * ``DecodePolicy.shared_mask_step`` and ``level_free_step`` are bitwise
    equal to the port's per-level ``step`` (single matrix and stacked
    store, rows at mixed levels, ``share_width`` None, 2 and N) and within
    rtol 1e-6 of JAX's (integers equal); a ``dense_d = 2`` index refuses;
  * ``paged_decode_step`` is bitwise equal to the port's ``decode_step`` at
    each level (rows at mixed levels too) and within 1e-5 of JAX's on
    carried-over float32 weights;
  * ``ContinuousServingEngine``, at the reference test's sizes
    (``tests/test_continuous.py``), gives the port ``ServingEngine``'s SIDs
    and scores bit for bit, also across a hot swap, with 0 unexpected
    specializations; refills slots mid-flight, counts both share-hit
    kinds, sheds by deadline, refuses a policy that is not level-free; and
    gives JAX's ``ContinuousServingEngine``'s SIDs, scores within 1e-4.

Tests with a counterpart in ``tests/test_continuous.py`` keep its name.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro.constraints import ConstraintRegistry as JaxConstraintRegistry
from repro.constraints import ItemCatalog as JaxItemCatalog
from repro.constraints import category_allowlist as jax_category_allowlist
from repro.constraints import freshness_window as jax_freshness_window
from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.decoding import DecodePolicy as JaxDecodePolicy
from repro.models import kvcache as jax_kvcache
from repro.models import transformer as jax_transformer
from repro.scenarios import gr_model_config
from repro.serving.continuous import (
    ContinuousServingEngine as JaxContinuousServingEngine,
)
from repro.serving.continuous import PagedKVAllocator as JaxPagedKVAllocator
from repro.serving.continuous import PrefixShareTable as JaxPrefixShareTable
from repro.serving.continuous import StepScheduler as JaxStepScheduler
from repro.serving.engine import RequestQueue as JaxRequestQueue
from repro.serving.generative_retrieval import (
    GenerativeRetriever as JaxGenerativeRetriever,
)
from repro_torch.configs.base import TransformerConfig
from repro_torch.constraints import (
    ConstraintRegistry,
    ItemCatalog,
    category_allowlist,
    freshness_window,
)
from repro_torch.convert import (
    params_from_jax,
    store_from_numpy,
    transition_matrix_from_numpy,
)
from repro_torch.core import TransitionMatrix
from repro_torch.decoding import DecodePolicy
from repro_torch.launch import serve as launcher
from repro_torch.models import kvcache
from repro_torch.models import transformer
from repro_torch.observability import compile_events
from repro_torch.reliability import FaultInjector, FaultSpec, active_injector
from repro_torch.reliability import faults
from repro_torch.serving import GenerativeRetriever, RequestQueue, ServingEngine
from repro_torch.serving.continuous import (
    ContinuousServingEngine,
    PagedKVAllocator,
    PrefixShareTable,
    StepScheduler,
)
from conftest import make_sids


def _alloc_state(a):
    return (a.n_free, a.n_referenced, sorted(a._free),
            sorted(a._ref.items()), a.utilization())


# ---------------------------------------------------------------------------
# paged allocator and prefix-share table: the reference's state, op by op
# ---------------------------------------------------------------------------
def test_allocator_directed_errors():
    for cls in (PagedKVAllocator, JaxPagedKVAllocator):
        with pytest.raises(ValueError):
            cls(1)
    a, ja = PagedKVAllocator(4), JaxPagedKVAllocator(4)  # pages 1..3
    p = a.alloc(2)
    assert p == ja.alloc(2)
    for alloc in (a, ja):
        with pytest.raises(MemoryError):
            alloc.alloc(2)
        alloc.retain(p)
        alloc.release(p)
        alloc.check()
        alloc.release(p)
        with pytest.raises(ValueError):
            alloc.release([p[0]])  # double free
        with pytest.raises(ValueError):
            alloc.retain([p[0]])  # retain of unowned page
        alloc.check()
        assert alloc.n_free == 3 and alloc.n_referenced == 0
    assert _alloc_state(a) == _alloc_state(ja)


def test_allocator_page_alloc_fault_leaves_the_invariant():
    a = PagedKVAllocator(6)
    inj = FaultInjector([FaultSpec("kv.page_alloc", mode="nth", calls=(1,))])
    with active_injector(inj):
        a.alloc(2)
        with pytest.raises(Exception, match="kv.page_alloc"):
            a.alloc(2)
        a.check()
        assert a.n_free == 3
        a.alloc(3)
    assert inj.n_fires("kv.page_alloc") == 1


def test_allocator_property_random_interleavings():
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(st.lists(st.integers(0, 2 ** 16), min_size=1, max_size=80),
           st.integers(4, 24))
    def run(ops, n_pages):
        a, ja = PagedKVAllocator(n_pages), JaxPagedKVAllocator(n_pages)
        held: list[int] = []
        for op in ops:
            kind = op % 3
            if kind == 0:  # alloc 1..2 pages
                n = 1 + (op // 3) % 2
                if n <= a.n_free:
                    got = a.alloc(n)
                    assert got == ja.alloc(n)
                    held += got
                else:
                    for alloc in (a, ja):
                        with pytest.raises(MemoryError):
                            alloc.alloc(n)
            elif kind == 1 and held:  # retain a held page
                pg = held[(op // 3) % len(held)]
                a.retain([pg])
                ja.retain([pg])
                held.append(pg)
            elif kind == 2 and held:  # release a held reference
                pg = held.pop((op // 3) % len(held))
                a.release([pg])
                ja.release([pg])
            a.check()
            assert _alloc_state(a) == _alloc_state(ja)
        for pg in held:
            a.release([pg])
        a.check()
        assert a.n_free == n_pages - 1 and a.n_referenced == 0

    run()


def test_prefix_share_table_refcounts_and_lru():
    def drive(alloc_cls, table_cls):
        a = alloc_cls(8)
        t = table_cls(a, capacity=2)
        rows = [np.full(4, i, np.int32) for i in range(3)]
        pages = [a.alloc(2) for _ in range(3)]
        logits = [np.full(5, float(i), np.float32) for i in range(3)]
        trace = []
        t.insert(rows[0], pages[0], logits[0])
        t.insert(rows[1], pages[1], logits[1])
        t.insert(rows[1], pages[2], logits[2])  # duplicate: keeps the first
        trace.append((a.refcount(pages[0][0]), a.refcount(pages[2][0])))
        trace.append((t.contains(rows[0]), t.contains(rows[2]), len(t)))
        got_pages, got_logits = t.lookup(rows[0])
        trace.append((tuple(got_pages), got_logits.tolist(),
                      a.refcount(pages[0][0])))
        a.release(got_pages)
        assert t.lookup(rows[2]) is None
        t.insert(rows[2], pages[2], logits[2])  # row 0 is MRU: evicts row 1
        trace.append((t.contains(rows[1]), t.contains(rows[0]),
                      a.refcount(pages[1][0]), t.hits, t.misses))
        t.drop_all()
        a.check()
        for pg in pages:
            a.release(pg)
        a.check()
        trace.append((a.n_free, len(t)))
        return trace

    got = drive(PagedKVAllocator, PrefixShareTable)
    assert got == drive(JaxPagedKVAllocator, JaxPrefixShareTable)
    assert got[0] == (2, 1) and got[-1] == (7, 0)


# ---------------------------------------------------------------------------
# step scheduler: the reference's admissions, shedding and evictions
# ---------------------------------------------------------------------------
def _sched_trace(sched_cls, queue_cls):
    trace = []
    sched = sched_cls(n_slots=4, sid_length=2, prefill_chunk=2,
                      deadline_s=10.0)
    q = queue_cls()
    for i in range(7):
        q.submit(np.full(4, i % 3, np.int32), 2, constraint_id=i % 2)
    for lane in q._lanes.values():  # age rid 3 past the deadline
        for req in lane:
            if req.rid == 3:
                req.t_enqueue = time.monotonic() - 99.0
    trace.append(("shed", [r.rid for r in sched.shed_expired(q)]))
    seen = set()

    def probe(r):  # a share hit once an equal prompt was admitted
        return int(r.prompt[0]) in seen

    for step in range(6):
        admissions, fresh = sched.plan_admissions(q, probe)
        trace.append(("admit", [(s, r.rid, hit) for s, r, hit in admissions],
                      [(s, r.rid) for s, r in fresh]))
        for slot, r, _ in admissions:
            sched.admit(slot, r, now=float(step))
            seen.add(int(r.prompt[0]))
        sched.advance(now=float(step) + 0.5)
        trace.append(("levels", sched.levels().tolist(),
                      sched.live_mask().tolist(), sched.completed()))
        for i in sched.completed():
            st = sched.evict(i)
            trace.append(("evict", i, st.request.rid, st.level, st.t_first,
                          sched.slots[i].served))
    trace.append(("left", len(q), sched.n_live, sched.free_slots()))
    return trace


def test_scheduler_matches_reference_step_by_step():
    got = _sched_trace(StepScheduler, RequestQueue)
    assert got == _sched_trace(JaxStepScheduler, JaxRequestQueue)
    assert got[0] == ("shed", [3])
    assert got[1][2] == [(0, 0), (1, 1)]  # the chunk caps fresh prefills


def test_scheduler_chunked_admission_caps_fresh_prefills():
    sched = StepScheduler(n_slots=6, sid_length=3, prefill_chunk=2)
    q = RequestQueue()
    for i in range(6):
        q.submit(np.full(4, i, np.int32), 3)
    admissions, fresh = sched.plan_admissions(q, lambda r: False)
    assert len(fresh) == 2 and len(admissions) == 2
    assert len(q) == 4
    for slot, r, _ in admissions:
        sched.admit(slot, r)
    admissions2, fresh2 = sched.plan_admissions(q, lambda r: True)
    assert len(admissions2) == 4 and not fresh2
    assert all(hit for _, _, hit in admissions2)


# ---------------------------------------------------------------------------
# paged pools
# ---------------------------------------------------------------------------
def test_scatter_and_gather_pages_match_reference(rng):
    nl, P, ps, kvh, hd, B, S = 2, 9, 4, 2, 3, 3, 10
    assert kvcache.pages_for(S, ps) == jax_kvcache.pages_for(S, ps) == 3
    rows = rng.normal(size=(nl, B, S, kvh, hd)).astype(np.float32)
    ids = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    k, v = kvcache.init_page_pool(nl, P, ps, kvh, hd, dtype=torch.float32,
                                  device="cpu")
    jk, _ = jax_kvcache.init_page_pool(nl, P, ps, kvh, hd)
    assert k.shape == v.shape == jk.shape and not k.any()
    kvcache.scatter_pages(k, torch.from_numpy(rows), torch.from_numpy(ids))
    jk = jax_kvcache.scatter_pages(jk, jnp.asarray(rows), jnp.asarray(ids))
    live = [p for p in range(P) if p not in (0,)]  # page 0 takes padding
    np.testing.assert_array_equal(k.numpy()[:, live], np.asarray(jk)[:, live])
    table = np.array([[4, 5, 6], [1, 2, 3]], np.int32)
    for layer in range(nl):
        got = kvcache.gather_pages(k[layer], torch.from_numpy(table), S)
        want = jax_kvcache.gather_pages(jk[layer], jnp.asarray(table), S)
        assert got.shape == (2, S, kvh, hd)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy()[1], rows[layer, 0])


# ---------------------------------------------------------------------------
# level-free and shared masking
# ---------------------------------------------------------------------------
VOCAB, SL = 24, 3


@pytest.fixture(scope="module")
def mask_policies():
    """{single, stacked}: (port policy, JAX policy, constraint ids or None)
    over the same dense_d=0 index."""
    rng = np.random.default_rng(3)
    jtm = JaxTransitionMatrix.from_sids(make_sids(rng, 60, VOCAB, SL), VOCAB,
                                        dense_d=0)
    tm = transition_matrix_from_numpy(jtm, device="cpu")
    cat = dict(sids=make_sids(rng, 120, VOCAB, SL),
               age_days=rng.uniform(0, 90, 120),
               category=rng.integers(0, 4, 120))
    jreg = JaxConstraintRegistry(VOCAB, dense_d=0)
    jreg.register("fresh", jax_freshness_window(45.0))
    jreg.register("cats", jax_category_allowlist(0, 1))
    jstore = jreg.build(JaxItemCatalog(**cat))
    store = store_from_numpy(jstore, device="cpu")
    return {"single": (DecodePolicy.static(tm), JaxDecodePolicy.static(jtm)),
            "stacked": (DecodePolicy.stacked(store),
                        JaxDecodePolicy.stacked(jstore))}


def _walk(policy, rng, B, M, cids):
    """Per-level logits, nodes, and the per-level step's outputs along
    the best edges."""
    nodes = torch.ones((B, M), dtype=torch.int32)
    out = []
    for step in range(SL):
        logits = torch.from_numpy(
            rng.standard_normal((B, M, VOCAB)).astype(np.float32))
        lp, nxt = policy.step(logits, nodes, step, constraint_ids=cids)
        out.append((logits, nodes, lp, nxt))
        tok = lp.argmax(-1)
        nodes = nxt.gather(-1, tok[..., None])[..., 0].to(torch.int32)
    return out


@pytest.mark.parametrize("kind", ["single", "stacked"])
def test_shared_mask_step_bitwise_vs_per_level(mask_policies, kind):
    policy, jpolicy = mask_policies[kind]
    assert policy.supports_level_free and jpolicy.supports_level_free
    B, M, N = 4, 3, 12
    cids = (None if kind == "single" else
            torch.tensor([[0], [1], [1], [0]], dtype=torch.int32).expand(B, M))
    cflat = None if cids is None else cids.reshape(N).contiguous()
    for logits, nodes, lp, nxt in _walk(policy, np.random.default_rng(5), B,
                                        M, cids):
        flat = (logits.reshape(N, VOCAB), nodes.reshape(N))
        for share_width in (None, 2, N):
            got_lp, got_next, n_uni = policy.shared_mask_step(
                *flat, constraint_ids=cflat, share_width=share_width)
            assert torch.equal(got_lp, lp.reshape(N, VOCAB))
            assert torch.equal(got_next, nxt.reshape(N, VOCAB))
            j_lp, j_next, j_uni = jpolicy.shared_mask_step(
                *(jnp.asarray(t.numpy()) for t in flat),
                constraint_ids=None if cflat is None else jnp.asarray(
                    cflat.numpy()),
                share_width=share_width)
            np.testing.assert_allclose(got_lp.numpy(), np.asarray(j_lp),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(got_next.numpy(),
                                          np.asarray(j_next))
            assert int(n_uni) == int(j_uni) <= N
        got = policy.level_free_step(*flat, constraint_ids=cflat)
        assert torch.equal(got[0], lp.reshape(N, VOCAB))
        assert torch.equal(got[1], nxt.reshape(N, VOCAB))


@pytest.mark.parametrize("kind", ["single", "stacked"])
def test_level_free_step_serves_rows_at_mixed_levels(mask_policies, kind):
    """One call over rows taken from every level equals the per-level step
    of each row."""
    policy, _ = mask_policies[kind]
    B, M = 4, 3
    cids = (None if kind == "single" else
            torch.tensor([[0], [1], [0], [1]], dtype=torch.int32).expand(B, M))
    walk = _walk(policy, np.random.default_rng(9), B, M, cids)
    level = np.arange(B * M) % SL  # row r takes level r % 3
    pick = [walk[lv][0].reshape(-1, VOCAB)[r] for r, lv in enumerate(level)]
    nodes = torch.stack([walk[lv][1].reshape(-1)[r]
                         for r, lv in enumerate(level)])
    cflat = None if cids is None else cids.reshape(-1).contiguous()
    got_lp, got_next = policy.level_free_step(torch.stack(pick), nodes,
                                              constraint_ids=cflat)
    for r, lv in enumerate(level):
        assert torch.equal(got_lp[r], walk[lv][2].reshape(-1, VOCAB)[r])
        assert torch.equal(got_next[r], walk[lv][3].reshape(-1, VOCAB)[r])
    shared = policy.shared_mask_step(torch.stack(pick), nodes,
                                     constraint_ids=cflat, share_width=5)
    assert torch.equal(shared[0], got_lp) and torch.equal(shared[1], got_next)


def test_level_free_requires_all_sparse_index(rng):
    sids = make_sids(rng, 40, 16, 3)
    tm = TransitionMatrix.from_sids(sids, 16, dense_d=2, device="cpu")
    policy = DecodePolicy.static(tm)
    assert not policy.supports_level_free
    for fn in (policy.shared_mask_step, policy.level_free_step):
        with pytest.raises(ValueError, match="dense_d=0"):
            fn(torch.zeros((4, 16)), torch.ones(4, dtype=torch.int32))
    assert not policy.backends[1].supports_level_free
    with pytest.raises(ValueError, match="dense_d=0"):
        policy.backends[1].level_free_mask(torch.zeros((4, 16)),
                                           torch.ones(4, dtype=torch.int32))
    # the compressed slab opts out even over a dense_d=0 index
    tm0 = TransitionMatrix.from_sids(sids, 16, dense_d=0, device="cpu")
    assert DecodePolicy.static(tm0).supports_level_free
    assert not DecodePolicy.static(tm0, compressed=True).supports_level_free


def test_level_free_stacked_store_requires_all_sparse_and_ids():
    rng = np.random.default_rng(4)
    cat = ItemCatalog(sids=make_sids(rng, 80, 16, 3),
                      age_days=rng.uniform(0, 90, 80),
                      category=rng.integers(0, 4, 80))
    reg = ConstraintRegistry(16, dense_d=2, device="cpu")
    reg.register("fresh", freshness_window(45.0))
    policy = DecodePolicy.stacked(reg.build(cat))
    assert not policy.supports_level_free
    with pytest.raises(ValueError, match="dense_d=0"):
        policy.shared_mask_step(torch.zeros((2, 16)),
                                torch.ones(2, dtype=torch.int32),
                                constraint_ids=torch.zeros(2, dtype=torch.int32))
    reg0 = ConstraintRegistry(16, dense_d=0, device="cpu")
    reg0.register("fresh", freshness_window(45.0))
    policy0 = DecodePolicy.stacked(reg0.build(cat))
    with pytest.raises(ValueError, match="constraint_ids"):
        policy0.level_free_step(torch.zeros((2, 16)),
                                torch.ones(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# paged decode step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = JaxTransformerConfig(
        name="gr-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=34, dtype="float32", tie_embeddings=True,
        attn_chunk_q=8)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    jparams = jax_transformer.init_params(jcfg, jax.random.key(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, cfg, jparams, params


def test_paged_decode_step_bitwise_vs_decode_step(tiny_lm):
    """Slot b, beam m at level l computes what the l-th sequential
    ``decode_step`` computed for row b*M + m: all slots at one level, then
    rows at mixed levels (and a dead slot writing the trash column)."""
    jcfg, cfg, jparams, params = tiny_lm
    rng = np.random.default_rng(2)
    slots, M, S, L, ps = 3, 2, 6, 4, 4
    N, Ls, hd = slots * M, L + 1, cfg.resolved_head_dim()
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (slots, S)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (L, slots, M)))
    with torch.inference_mode():
        _, cache = transformer.prefill(params, prompts, cfg, max_len=S + Ls)
        _, hist = transformer.prefill(params, prompts, cfg, max_len=S)
        cache = dataclasses.replace(
            cache, k=cache.k.repeat_interleave(M, dim=1),
            v=cache.v.repeat_interleave(M, dim=1))
        want = {}
        for lv in range(1, L):
            logits, cache = transformer.decode_step(
                params, cache, toks[lv].reshape(N, 1), cfg)
            want[lv] = logits
        n_pages = kvcache.pages_for(S, ps)
        table = torch.arange(1, 1 + slots * n_pages).reshape(slots, n_pages)
        pools = [kvcache.init_page_pool(cfg.n_layers, 1 + slots * n_pages, ps,
                                        cfg.n_kv_heads, hd,
                                        dtype=torch.float32, device="cpu")[0]
                 for _ in range(2)]
        for pool, rows in zip(pools, (hist.k, hist.v)):
            kvcache.scatter_pages(pool, rows, table)
        shape = (cfg.n_layers, slots, M, Ls, cfg.n_kv_heads, hd)
        sk, sv = torch.zeros(shape), torch.zeros(shape)
        for lv in range(1, L):  # every slot at level lv
            logits, sk, sv = transformer.paged_decode_step(
                params, *pools, table, sk, sv, toks[lv], torch.full(
                    (slots,), S + lv - 1), torch.full((slots,), lv - 1), cfg,
                hist_len=S)
            assert torch.equal(logits, want[lv]), f"level {lv}"
        # the suffix holds the sequential cache's decode columns
        seq_k = cache.k[:, :, S:S + L - 1].reshape(
            cfg.n_layers, slots, M, L - 1, cfg.n_kv_heads, hd)
        assert torch.equal(sk[:, :, :, :L - 1], seq_k)
        # mixed levels: slot 0 at level 3, slot 1 at level 1, slot 2 dead
        levels = torch.tensor([3, 1, 2])
        logits, sk, _ = transformer.paged_decode_step(
            params, *pools, table, sk, sv,
            torch.stack([toks[3][0], toks[1][1], toks[2][2]]),
            S + levels - 1, torch.tensor([2, 0, Ls - 1]), cfg, hist_len=S)
        for b, lv in ((0, 3), (1, 1)):
            assert torch.equal(logits[b * M:(b + 1) * M],
                               want[lv][b * M:(b + 1) * M])

        # JAX's paged step on the same inputs, from a zero suffix
        jsk = jnp.zeros(shape, jnp.float32)
        sk0, sv0 = torch.zeros(shape), torch.zeros(shape)
        for lv in range(1, L):
            pos, col = jnp.full((slots,), S + lv - 1), jnp.full((slots,), lv - 1)
            jl, jsk, jsv = jax_transformer.paged_decode_step(
                jparams, *(jnp.asarray(p.numpy()) for p in pools),
                jnp.asarray(table.numpy(), jnp.int32), jsk,
                jnp.zeros(shape, jnp.float32) if lv == 1 else jsv,
                jnp.asarray(toks[lv].numpy(), jnp.int32), pos, col, jcfg,
                hist_len=S)
            got, sk0, sv0 = transformer.paged_decode_step(
                params, *pools, table, sk0, sv0, toks[lv],
                torch.full((slots,), S + lv - 1),
                torch.full((slots,), lv - 1), cfg, hist_len=S)
            np.testing.assert_allclose(got.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(sk0.numpy(), np.asarray(jsk),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("field,value", [
    ("sliding_window", 4), ("defer_cache_write", True),
    ("decode_split_k", True), ("attention", "mla")])
def test_paged_decode_step_refuses_unported_paths(tiny_lm, field, value):
    _, cfg, _, params = tiny_lm
    bad = dataclasses.replace(cfg, **{field: value})
    z = torch.zeros((2, 2, 2, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="paged_decode_step"):
        transformer.paged_decode_step(
            params, z, z, torch.zeros((1, 1), dtype=torch.int32), z, z,
            torch.zeros((1, 2), dtype=torch.int64), torch.zeros(1),
            torch.zeros(1), bad, hist_len=4)


# ---------------------------------------------------------------------------
# the engine: the reference test's sizes
# ---------------------------------------------------------------------------
GV, GL, GBEAM = 32, 3, 4


def _catalog(seed, n=300):
    rng = np.random.default_rng(seed)
    return dict(sids=rng.integers(0, GV, (n, GL)),
                age_days=rng.uniform(0.0, 90.0, n),
                category=rng.integers(0, 8, n))


@pytest.fixture(scope="module")
def gr_stack():
    jcfg = gr_model_config(GV)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    jparams = jax_transformer.init_params(jcfg, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    reg = ConstraintRegistry(GV, dense_d=0, headroom=0.5, device="cpu")
    reg.register("fresh", freshness_window(60.0))
    reg.register("cats", category_allowlist(0, 1, 2, 3))
    reg.build(ItemCatalog(**_catalog(7)))
    retr = GenerativeRetriever(params, cfg, DecodePolicy.stacked(
        reg.current()[0]), GL, GV, beam_size=GBEAM)
    c0 = compile_events()
    cont = ContinuousServingEngine(
        retr, registry=reg, slots=5, prompt_width=8, page_size=4,
        prefill_chunk=2, share_width=12)
    warm = compile_events() - c0
    ref = ServingEngine(params, cfg, batch_size=3, max_len=16,
                        retriever=retr, registry=reg)
    return dict(cfg=cfg, jcfg=jcfg, params=params, jparams=jparams,
                registry=reg, ref=ref, cont=cont, warm_specializations=warm)


def _prompts(n, seed, dup_every=4):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, GV, size=(n, 8)).astype(np.int32)
    for i in range(dup_every, n, dup_every):
        prompts[i] = prompts[i - dup_every]  # exercise prompt sharing
    return prompts


def _drive(engines, n_req, seed):
    """Serve the same requests through each (engine, queue class)."""
    prompts = _prompts(n_req, seed)
    out = []
    for eng, queue_cls in engines:
        q = queue_cls()
        for i in range(n_req):
            q.submit(prompts[i], GL, int(i % 2))
        out.append(eng.serve(q))
    return out


def _assert_bit_equal(a, b):
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid]["sids"], b[rid]["sids"],
                                      err_msg=f"rid {rid}: SIDs diverged")
        np.testing.assert_array_equal(a[rid]["scores"], b[rid]["scores"],
                                      err_msg=f"rid {rid}: scores diverged")
        assert b[rid]["constraint_id"] == a[rid]["constraint_id"]
        assert b[rid]["store_version"] == a[rid]["store_version"]
        assert "latency_s" in b[rid] and "queue_s" in b[rid]


def test_warmup_specializes_the_step_once(gr_stack):
    assert gr_stack["warm_specializations"] == 1
    cont = gr_stack["cont"]
    assert cont.slots == 5 and cont.num_sets == 2
    assert cont.n_hist_pages == 2
    assert cont.alloc.n_pages == 1 + (5 + 2 + 64) * 2


def test_fuzz_bit_identical_to_serving_engine(gr_stack):
    a, b = _drive([(gr_stack["ref"], RequestQueue),
                   (gr_stack["cont"], RequestQueue)], 13, seed=11)
    _assert_bit_equal(a, b)


def test_fuzz_bit_identical_across_hot_swap(gr_stack):
    cont = gr_stack["cont"]
    gr_stack["registry"].swap(ItemCatalog(**_catalog(13)))
    c0 = compile_events()
    a, b = _drive([(gr_stack["ref"], RequestQueue),
                   (cont, RequestQueue)], 9, seed=17)
    _assert_bit_equal(a, b)
    assert {r["store_version"] for r in b.values()} == {2}
    assert compile_events() == c0  # neither engine specialized anew
    assert cont.cold_swaps == 0
    assert cont.metrics.counter("serving_hot_swaps_total").total() >= 1
    unexpected = cont.metrics.counter(
        "serving_recompiles_total").value(expected="false")
    assert int(unexpected) == 0, "a hot swap specialized the continuous step"


def test_mid_flight_admission_and_sharing_counters(gr_stack):
    cont = gr_stack["cont"]
    _drive([(cont, RequestQueue)], 12, seed=23)
    assert int(cont._slot_reuse.total()) > 0, \
        "no slot was ever refilled mid-flight"
    hits = cont.metrics.counter("serving_prefix_share_hits_total")
    assert int(hits.value(kind="prompt")) > 0
    assert int(hits.value(kind="mask_row")) > 0
    assert cont.metrics.counter("serving_admissions_total").total() >= 12
    assert len(cont.unique_per_step) > 0
    assert all(1 <= u <= 5 * GBEAM for u in cont.unique_per_step)
    assert 0.0 <= cont.metrics.gauge(
        "serving_kv_page_pool_utilization").value() <= 1.0
    cont.alloc.check()  # a drained serve leaves the page pool consistent


def test_deadline_shedding_end_to_end(gr_stack):
    cont = gr_stack["cont"]
    cont.sched.deadline_s = 0.0  # every queued request is already late
    try:
        q = RequestQueue()
        rng = np.random.default_rng(29)
        rids = [q.submit(rng.integers(0, GV, 8).astype(np.int32), GL, 0)
                for _ in range(3)]
        before = int(cont._m.rejected.total())
        out = cont.serve(q)
        assert all(out[rid]["reason"] == "deadline" for rid in rids)
        assert all("sids" not in out[rid] for rid in rids)
        assert int(cont._m.rejected.total()) == before + 3
    finally:
        cont.sched.deadline_s = None


def test_decode_fault_retries_the_step_bit_identically(gr_stack):
    cont = gr_stack["cont"]
    (clean,) = _drive([(cont, RequestQueue)], 4, seed=31)
    inj = FaultInjector([FaultSpec("decode.slow_step", mode="nth",
                                   calls=(0, 2))])
    with active_injector(inj):
        (faulty,) = _drive([(cont, RequestQueue)], 4, seed=31)
    assert inj.n_fires("decode.slow_step") == 2
    for (_, a), (_, b) in zip(sorted(clean.items()), sorted(faulty.items())):
        np.testing.assert_array_equal(a["sids"], b["sids"])
        np.testing.assert_array_equal(a["scores"], b["scores"])


def test_page_alloc_faults_requeue_then_shed(gr_stack):
    cont = gr_stack["cont"]
    inj = FaultInjector([FaultSpec("kv.page_alloc", mode="always")])
    q = RequestQueue()
    rid = q.submit(np.arange(8, dtype=np.int32) + 7, GL, 0)
    with active_injector(inj):
        out = cont.serve(q)
    assert out[rid]["reason"] == "kv_pages"
    cont.alloc.check()


def test_continuous_rejects_non_level_free_policy():
    rng = np.random.default_rng(31)
    tm = TransitionMatrix.from_sids(make_sids(rng, 40, 16, 3), 16, dense_d=2,
                                    device="cpu")
    cfg = TransformerConfig(**dataclasses.asdict(gr_model_config(16)))
    params = transformer.init_params(cfg, seed=1, device="cpu")
    retr = GenerativeRetriever(params, cfg, DecodePolicy.static(tm), 3, 16,
                               beam_size=2)
    with pytest.raises(ValueError, match="dense_d=0"):
        ContinuousServingEngine(retr, slots=2)


def test_cold_swap_specializes_the_step_once():
    """A registry that outgrows its zero-headroom envelope: the next step
    specializes once, the one after not at all."""
    cfg = TransformerConfig(**dataclasses.asdict(gr_model_config(GV)))
    params = transformer.init_params(cfg, seed=2, device="cpu")
    reg = ConstraintRegistry(GV, dense_d=0, headroom=0.0, device="cpu")
    reg.register("fresh", freshness_window(60.0))
    reg.build(ItemCatalog(**_catalog(3, n=40)))
    retr = GenerativeRetriever(params, cfg, DecodePolicy.stacked(
        reg.current()[0]), GL, GV, beam_size=2)
    eng = ContinuousServingEngine(retr, registry=reg, slots=2,
                                  prompt_width=8, page_size=4)
    prompts = _prompts(3, 5)

    def serve():
        q = RequestQueue()
        for p in prompts:
            q.submit(p, GL, 0)
        c0 = compile_events()
        out = eng.serve(q)
        assert all("sids" in r for r in out.values()) and len(out) == 3
        return compile_events() - c0

    assert serve() == 0  # warm-up took the first
    reg.swap(ItemCatalog(**_catalog(4, n=600)))
    assert reg.envelope_generation == 2
    assert [serve(), serve()] == [1, 0]
    assert eng.cold_swaps == 1
    recompiles = eng.metrics.counter("serving_recompiles_total")
    assert recompiles.value(expected="true") == 1
    assert recompiles.value(expected="false") == 0


def test_continuous_matches_jax_continuous_engine(gr_stack):
    """The same requests through JAX's ContinuousServingEngine on the
    carried-over weights: SIDs equal, scores within 1e-4 (float32 matmul
    and reduction orders differ)."""
    jreg = JaxConstraintRegistry(GV, dense_d=0, headroom=0.5)
    jreg.register("fresh", jax_freshness_window(60.0))
    jreg.register("cats", jax_category_allowlist(0, 1, 2, 3))
    reg = ConstraintRegistry(GV, dense_d=0, headroom=0.5, device="cpu")
    reg.register("fresh", freshness_window(60.0))
    reg.register("cats", category_allowlist(0, 1, 2, 3))
    cat = _catalog(19)
    jstore = jreg.build(JaxItemCatalog(**cat))
    store = reg.build(ItemCatalog(**cat))
    kw = dict(slots=5, prompt_width=8, page_size=4, prefill_chunk=2,
              share_width=12)
    jeng = JaxContinuousServingEngine(
        JaxGenerativeRetriever(gr_stack["jparams"], gr_stack["jcfg"],
                               JaxDecodePolicy.stacked(jstore), GL, GV,
                               beam_size=GBEAM), registry=jreg, **kw)
    eng = ContinuousServingEngine(
        GenerativeRetriever(gr_stack["params"], gr_stack["cfg"],
                            DecodePolicy.stacked(store), GL, GV,
                            beam_size=GBEAM), registry=reg, **kw)
    got, want = _drive([(eng, RequestQueue), (jeng, JaxRequestQueue)], 12,
                       seed=41)
    assert got.keys() == want.keys()
    for rid, w in want.items():
        np.testing.assert_array_equal(got[rid]["sids"], w["sids"])
        np.testing.assert_allclose(got[rid]["scores"], w["scores"],
                                   rtol=1e-4, atol=1e-4)
        assert got[rid]["store_version"] == w["store_version"] == 1
    for name, kind in (("serving_prefix_share_hits_total", "prompt"),
                       ("serving_prefix_share_hits_total", "mask_row")):
        assert eng.metrics.counter(name).value(kind=kind) == \
            jeng.metrics.counter(name).value(kind=kind)
    for name in ("serving_slot_reuse_total", "serving_admissions_total",
                 "serving_requests_total"):
        assert eng.metrics.counter(name).total() == \
            jeng.metrics.counter(name).total()


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["batch", "continuous"])
def test_launcher_serves_each_engine_on_the_cpu(tmp_path, engine):
    path = tmp_path / "metrics.jsonl"
    argv = ["--config", "small", "--constraints", "2000", "--batch", "2",
            "--beam", "4", "--requests", "2", "--device", "cpu",
            "--engine", engine, "--metrics-json", str(path),
            "--fault-schedule", '{"seed": 0, "faults": [{"point": '
            '"decode.slow_step", "mode": "nth", "calls": [0]}]}']
    assert launcher.main(argv) == 0
    assert faults._ACTIVE is None  # the schedule ends with the run
    snap = path.read_text().strip().splitlines()
    assert len(snap) == 1
    want = ("serving_prefix_share_hits_total" if engine == "continuous"
            else "step_wall_seconds")
    assert want in snap[0]
