"""Port batch engine, request queue and telemetry against the JAX reference.

A small transformer's weights go through ``convert.params_from_jax``, so
both packages serve with the same numbers:
  * ``RequestQueue`` pops, sheds and reports lanes as the reference's does
    for the same submission sequence;
  * the retrieval engine over a two-slot registry gives the reference
    engine's SIDs, scores within 1e-4 (float32 matmul and reduction orders
    differ), store versions and counter values, through a delta swap;
  * an async hot swap makes no new specialization of the retrieve step (the
    port's compile counter) and a cold swap exactly one, then none;
  * a ``decode.slow_step`` fault becomes ``decode_fault`` error results
    and a breaker failure;
  * greedy ``generate``/``serve`` equal the reference token for token, and
    sampling is deterministic under a seeded ``torch.Generator``;
  * ``plan_info``, ``record_policy`` and ``render_prometheus`` equal the
    reference's.

Tests with a counterpart in ``tests/test_refresh.py`` keep its name.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro.constraints import CatalogDelta as JaxCatalogDelta
from repro.constraints import ConstraintRegistry as JaxConstraintRegistry
from repro.constraints import ItemCatalog as JaxItemCatalog
from repro.constraints import category_allowlist as jax_category_allowlist
from repro.constraints import freshness_window as jax_freshness_window
from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.decoding import DecodePolicy as JaxDecodePolicy
from repro.models import transformer as jax_transformer
from repro.observability import MetricsRegistry as JaxMetricsRegistry
from repro.observability import record_policy as jax_record_policy
from repro.serving.engine import RequestQueue as JaxRequestQueue
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.generative_retrieval import (
    GenerativeRetriever as JaxGenerativeRetriever,
)
from repro_torch.configs.base import TransformerConfig
from repro_torch.constraints import (
    AsyncRefresher,
    CatalogDelta,
    ConstraintRegistry,
    ItemCatalog,
    category_allowlist,
    freshness_window,
)
from repro_torch.convert import params_from_jax, transition_matrix_from_numpy
from repro_torch.core import NEG_INF
from repro_torch.decoding import DecodePolicy
from repro_torch.models import transformer
from repro_torch.observability import (
    MetricsRegistry,
    RecompileDetector,
    compile_events,
    record_policy,
)
from repro_torch.reliability import (
    OPEN,
    CircuitBreaker,
    FaultInjector,
    FaultSpec,
    active_injector,
)
from repro_torch.serving import GenerativeRetriever, RequestQueue, ServingEngine

V, L, M = 32, 4, 6  # SID vocab, SID length, beams
B, MAX_LEN = 4, 24  # engine batch; prompts are MAX_LEN // 2 wide
SEED = 0
COUNTERS = ("serving_requests_total", "serving_batches_total",
            "serving_decode_steps_total", "serving_hot_swaps_total",
            "serving_cold_swaps_total", "requests_shed_total",
            "serving_rejected_total")


@pytest.fixture(scope="module")
def lm():
    jcfg = JaxTransformerConfig(
        name="gr-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=34, dtype="float32", tie_embeddings=True,
        attn_chunk_q=8)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    jparams = jax_transformer.init_params(jcfg, jax.random.key(SEED))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, cfg, jparams, params


def catalog(rng, n):
    sids = np.unique(rng.integers(0, V, (n, L)), axis=0)
    m = sids.shape[0]
    return dict(sids=sids, age_days=rng.uniform(0, 60, m),
                category=rng.integers(0, 4, m))


def registry(headroom=0.5, metrics=None):
    reg = ConstraintRegistry(V, headroom=headroom, metrics=metrics,
                             device="cpu")
    reg.register("fresh", freshness_window(45))
    reg.register("cats", category_allowlist(0, 1, 2))
    return reg


def jax_registry(headroom=0.5):
    reg = JaxConstraintRegistry(V, headroom=headroom)
    reg.register("fresh", jax_freshness_window(45))
    reg.register("cats", jax_category_allowlist(0, 1, 2))
    return reg


def counters(metrics) -> dict:
    snap = metrics.snapshot()["counters"]
    return {k: snap.get(k, {}) for k in COUNTERS}


def assert_compliant(reg, results, version=None):
    """Every live beam lies in its row's slot set."""
    sets = [{tuple(r) for r in reg.slot_sids(s).astype(np.int64)}
            for s in range(len(reg.names))]
    for r in results.values():
        if "error" in r:  # shed: no SIDs
            continue
        if version is not None:
            assert r["store_version"] == version
        for sid, score in zip(r["sids"], r["scores"]):
            if score > NEG_INF / 2:
                assert tuple(int(t) for t in sid) in sets[r["constraint_id"]]


# ---------------------------------------------------------------------------
# RequestQueue
# ---------------------------------------------------------------------------
def _drive_queue(queue_cls):
    """One submission and drain script; returns what the queue did."""
    q = queue_cls()
    prompt = np.arange(5)
    for i, cid in enumerate([2, 2, 2, 2, 0, 1, 1, 0, 2]):
        q.submit(prompt + i, n_tokens=L, constraint_id=cid)
    q.submit(prompt, L, constraint_id=1, deadline_s=-1.0)  # shed at submit
    q.submit(prompt, L, constraint_id=0, deadline_s=0.05)  # expires queued
    q.submit(prompt, L, constraint_id=2, deadline_s=60.0)
    trace = [("depths", sorted(q.lane_depths().items())), ("len", len(q))]
    trace.append(("batch", [r.rid for r in q.pop_batch(4)]))
    time.sleep(0.1)
    trace.append(("peek", q.peek().rid))
    trace.append(("batch", [r.rid for r in q.pop_batch(3)]))
    trace.append(("swept", [r.rid for r in q.shed_expired(
        default_deadline_s=1e-9)]))
    trace.append(("rest", [r.rid for r in q.pop_batch(10)]))
    trace.append(("shed", [(r.rid, why) for r, why in q.drain_shed()]))
    trace.append(("end", len(q), sorted(q.lane_depths().items())))
    return trace


def test_request_queue_matches_reference():
    """Round-robin lanes, FIFO within a lane, and deadline shedding at
    submit, at pop and in the sweep, as the reference queue does."""
    got = _drive_queue(RequestQueue)
    assert got == _drive_queue(JaxRequestQueue)
    assert got[2] == ("batch", [0, 4, 5, 1])  # lanes 2, 0, 1 rotate


def test_request_queue_single_tenant_is_fifo():
    q = RequestQueue()
    rids = [q.submit(np.arange(3), n_tokens=2) for _ in range(6)]
    assert [r.rid for r in q.pop_batch(10)] == rids


# ---------------------------------------------------------------------------
# retrieval engine against the reference engine
# ---------------------------------------------------------------------------
def test_retrieval_engine_matches_reference(lm):
    jcfg, cfg, jparams, params = lm
    rng = np.random.default_rng(SEED)
    cat = catalog(rng, 300)
    reg, jreg = registry(), jax_registry()
    store, jstore = reg.build(ItemCatalog(**cat)), jreg.build(
        JaxItemCatalog(**cat))
    eng = ServingEngine(params, cfg, B, MAX_LEN, registry=reg,
                        retriever=GenerativeRetriever(params, cfg, store, L, V,
                                                      beam_size=M))
    jeng = JaxServingEngine(jparams, jcfg, B, MAX_LEN, registry=jreg,
                            retriever=JaxGenerativeRetriever(
                                jparams, jcfg, jstore, L, V, beam_size=M))

    def serve_both(n):
        prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 12)))
                   for _ in range(n)]
        out = []
        for e, q in ((eng, RequestQueue()), (jeng, JaxRequestQueue())):
            for i, p in enumerate(prompts):
                q.submit(p, n_tokens=L, constraint_id=i % 2)
            q.submit(prompts[0], L, constraint_id=1, deadline_s=-1.0)
            out.append(e.serve(q))
        return out

    for version in (1, 2):
        got, want = serve_both(6)
        assert got.keys() == want.keys() and len(got) == 7
        for rid, w in want.items():
            g = got[rid]
            if "error" in w:
                assert g == w
                continue
            assert g["store_version"] == w["store_version"] == version
            np.testing.assert_array_equal(g["sids"], w["sids"])
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4,
                                       atol=1e-4)
        assert_compliant(reg, got, version)
        rm = cat["sids"][rng.choice(cat["sids"].shape[0], 15, replace=False)]
        add = catalog(rng, 30)
        reg.swap_delta(CatalogDelta(added=ItemCatalog(**add),
                                    removed_sids=rm))
        jreg.swap_delta(JaxCatalogDelta(added=JaxItemCatalog(**add),
                                        removed_sids=rm))
    assert counters(eng.metrics) == counters(jeng.metrics)
    assert counters(eng.metrics)["serving_hot_swaps_total"] == {"": 2.0}
    assert eng.metrics.counter("serving_recompiles_total").value(
        expected="false") == 0
    assert eng.metrics.snapshot()["gauges"]["serving_store_version"] == \
        jeng.metrics.snapshot()["gauges"]["serving_store_version"]


def test_engine_async_hot_swap_zero_recompile_and_drain(lm):
    _, cfg, _, params = lm
    rng = np.random.default_rng(1)
    cat = catalog(rng, 300)
    reg = registry()
    store = reg.build(ItemCatalog(**cat))
    eng = ServingEngine(params, cfg, B, MAX_LEN, registry=reg,
                        retriever=GenerativeRetriever(params, cfg, store, L, V,
                                                      beam_size=4))
    q = RequestQueue()
    det = RecompileDetector()
    rids = [q.submit(rng.integers(0, cfg.vocab_size, (8,)), n_tokens=L,
                     constraint_id=i % 2) for i in range(6)]
    assert set(eng.serve(q)) == set(rids)
    assert det.count == 1  # the retriever's first batch

    rm = cat["sids"][rng.choice(cat["sids"].shape[0], 15, replace=False)]
    with AsyncRefresher(reg) as ref:
        fut = ref.apply_delta_async(CatalogDelta(
            added=ItemCatalog(**catalog(rng, 30)), removed_sids=rm))
        assert fut.result(timeout=60) == 2
    det.reset()
    rids2 = [q.submit(rng.integers(0, cfg.vocab_size, (8,)), n_tokens=L,
                      constraint_id=i % 2) for i in range(6)]
    results2 = eng.serve(q)
    assert set(results2) == set(rids2) and len(q) == 0  # nothing dropped
    assert_compliant(reg, results2, version=2)
    assert det.count == 0, "a hot swap specialized the retrieve step"
    assert eng.cold_swaps == 0
    assert eng.metrics.counter("serving_hot_swaps_total").total() == 2
    assert eng.metrics.counter("serving_recompiles_total").value(
        expected="false") == 0


def test_engine_cold_swap_recompiles_exactly_once(lm):
    _, cfg, _, params = lm
    rng = np.random.default_rng(2)
    reg = registry(headroom=0.0)
    store = reg.build(ItemCatalog(**catalog(rng, 80)))
    eng = ServingEngine(params, cfg, 2, MAX_LEN, registry=reg,
                        retriever=GenerativeRetriever(params, cfg, store, L, V,
                                                      beam_size=4))
    q = RequestQueue()
    for i in range(3):
        q.submit(rng.integers(0, cfg.vocab_size, (8,)), n_tokens=L,
                 constraint_id=i % 2)
    eng.serve(q)  # warm on the original envelope

    with AsyncRefresher(reg) as ref:  # outgrows the zero-headroom envelope
        assert ref.swap_async(ItemCatalog(**catalog(rng, 1500))).result(
            timeout=60) == 2
    assert reg.envelope_generation == 2
    c0 = compile_events()
    rids = [q.submit(rng.integers(0, cfg.vocab_size, (8,)), n_tokens=L,
                     constraint_id=i % 2) for i in range(5)]
    results = eng.serve(q)
    assert set(results) == set(rids) and len(q) == 0  # drained, none dropped
    assert eng.cold_swaps == 1
    assert compile_events() - c0 == 1
    assert eng.metrics.counter("serving_recompiles_total").value(
        expected="true") == 2  # the first batch and the cold swap
    assert eng.metrics.counter("serving_recompiles_total").value(
        expected="false") == 0
    assert_compliant(reg, results, version=2)
    # and the NEXT serve on the same version specializes nothing
    c0 = compile_events()
    q.submit(rng.integers(0, cfg.vocab_size, (8,)), n_tokens=L)
    eng.serve(q)
    assert compile_events() - c0 == 0


def test_decode_fault_becomes_error_results_and_breaker_failure(lm):
    _, cfg, _, params = lm
    rng = np.random.default_rng(3)
    reg = registry()
    store = reg.build(ItemCatalog(**catalog(rng, 200)))
    metrics = MetricsRegistry()
    breaker = CircuitBreaker(failure_threshold=1, recovery_s=60.0,
                             metrics=metrics)
    eng = ServingEngine(params, cfg, 2, MAX_LEN, registry=reg,
                        metrics=metrics, breaker=breaker,
                        retriever=GenerativeRetriever(params, cfg, store, L, V,
                                                      beam_size=4))
    q = RequestQueue()
    rids = [q.submit(rng.integers(0, cfg.vocab_size, (8,)), n_tokens=L,
                     constraint_id=i % 2) for i in range(4)]
    inj = FaultInjector([FaultSpec("decode.slow_step", mode="nth",
                                   calls=(0,))])
    with active_injector(inj):
        results = eng.serve(q)
    assert set(results) == set(rids)
    failed = [rid for rid, r in results.items() if "error" in r]
    assert failed == rids[:2]  # the first batch of two
    assert all(results[r]["reason"] == "decode_fault" for r in failed)
    assert all("sids" in results[r] for r in rids[2:])
    assert metrics.counter("requests_shed_total").value(
        reason="decode_fault") == 2
    assert breaker.state == OPEN
    assert metrics.counter("circuit_breaker_transitions_total").value(
        name="serving", **{"from": "closed", "to": "open"}) == 1


# ---------------------------------------------------------------------------
# plain-LM mode
# ---------------------------------------------------------------------------
def test_generate_and_serve_match_reference_greedy(lm):
    jcfg, cfg, jparams, params = lm
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    eng = ServingEngine(params, cfg, 2, 16)
    jeng = JaxServingEngine(jparams, jcfg, 2, 16)
    got = eng.generate(prompts, 5)
    assert got.dtype == np.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got, jeng.generate(prompts, 5))
    # and a manual prefill + decode_step loop
    with torch.inference_mode():
        logits, cache = transformer.prefill(
            params, torch.as_tensor(prompts, dtype=torch.int64), cfg,
            max_len=16)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        manual = [tok]
        for _ in range(4):
            logits, cache = transformer.decode_step(params, cache, tok, cfg)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            manual.append(tok)
    np.testing.assert_array_equal(got, torch.cat(manual, 1).numpy())

    queues = (RequestQueue(), JaxRequestQueue())
    for q in queues:
        for i, n in enumerate((3, 5, 2)):
            q.submit(prompts[i % 2][: 4 + i], n_tokens=n)
    assert eng.serve(queues[0]) == jeng.serve(queues[1])


def test_sampled_generate_is_deterministic_under_a_seed(lm):
    _, cfg, _, params = lm
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 8))
    eng = ServingEngine(params, cfg, 2, 16)

    def sample(seed):
        return eng.generate(prompts, 6, greedy=False,
                            generator=torch.Generator().manual_seed(seed))

    a = sample(7)
    np.testing.assert_array_equal(a, sample(7))
    assert a.shape == (2, 6) and a.min() >= 0 and a.max() < cfg.vocab_size
    assert any(not np.array_equal(a, sample(s)) for s in range(8, 12))
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(prompts, 2, greedy=False)
    with pytest.raises(ValueError, match="batch"):
        eng.generate(prompts[:1], 2)


# ---------------------------------------------------------------------------
# telemetry: plan_info, record_policy, render_prometheus
# ---------------------------------------------------------------------------
def _policy_pairs(rng):
    sids = rng.integers(0, V, (200, L))
    jtm = JaxTransitionMatrix.from_sids(sids, V, dense_d=2)
    tm = transition_matrix_from_numpy(jtm, device="cpu")
    jreg, reg = jax_registry(), registry()
    cat = catalog(rng, 200)
    jstore = jreg.build(JaxItemCatalog(**cat))
    store = reg.build(ItemCatalog(**cat))
    return {
        "static": (JaxDecodePolicy.static(jtm), DecodePolicy.static(tm)),
        "static_notopk": (JaxDecodePolicy.static(jtm, topk=False),
                          DecodePolicy.static(tm, topk=False)),
        "stacked": (JaxDecodePolicy.stacked(jstore),
                    DecodePolicy.stacked(store)),
        "compressed": (JaxDecodePolicy.static(jtm, compressed=True),
                       DecodePolicy.static(tm, compressed=True)),
        "ppv": (JaxDecodePolicy.ppv(sids, V),
                DecodePolicy.ppv(sids, V, device="cpu")),
        "hash_bitmap": (JaxDecodePolicy.hash_bitmap(sids, V, log2_bits=12),
                        DecodePolicy.hash_bitmap(sids, V, log2_bits=12,
                                                 device="cpu")),
        "cpu_trie": (JaxDecodePolicy.cpu_trie(sids, V),
                     DecodePolicy.cpu_trie(sids, V)),
        "unconstrained": (JaxDecodePolicy.unconstrained(),
                          DecodePolicy.unconstrained()),
    }


def test_plan_info_and_record_policy_match_reference():
    pairs = _policy_pairs(np.random.default_rng(6))
    for name, (jpol, pol) in pairs.items():
        for beams in (1, 6, 70):
            assert pol.plan_info(beams) == jpol.plan_info(beams), name
        jm, m = JaxMetricsRegistry(), MetricsRegistry()
        jax_record_policy(jm, jpol, beams=6)
        record_policy(m, pol, beams=6)
        assert m.render_prometheus() == jm.render_prometheus(), name
    assert [r["topk"] for r in pairs["static"][1].plan_info(6)] == \
        [False, False, True, True]


def _exercise(reg):
    c = reg.counter("ops_total", "ops, by kind")
    c.inc(kind="a")
    c.inc(2.5, kind="b", lane='x"y')
    reg.gauge("depth", "queue depth").set(3, lane="0")
    reg.gauge("depth").add(-1.5, lane="0")
    h = reg.histogram("lat_seconds", "latency")
    for v in (1e-6, 3e-5, 0.02, 0.02, 7.0, 1e9):
        h.observe(v, lane="1")
    h.observe(0.5)
    reg.histogram("tiny", buckets=(0.1, 1.0)).observe(0.1)
    return reg


def test_metrics_render_and_snapshot_match_reference(tmp_path):
    got, want = _exercise(MetricsRegistry()), _exercise(JaxMetricsRegistry())
    assert got.render_prometheus() == want.render_prometheus()
    g, w = got.snapshot(), want.snapshot()
    g.pop("ts"), w.pop("ts")
    assert g == w
    h = got.histogram("lat_seconds")
    assert h.count(lane="1") == 6 and h.quantile(0.5, lane="1") == \
        want.histogram("lat_seconds").quantile(0.5, lane="1")
    snap = got.write_snapshot(tmp_path / "m.jsonl")
    assert (tmp_path / "m.jsonl").read_text().count("\n") == 1
    assert snap["counters"]["ops_total"]['{kind="a"}'] == 1.0
    with pytest.raises(TypeError, match="already registered"):
        got.gauge("ops_total")
