"""Port HBM/host tiering against the untiered search and the JAX reference.

Mirrors ``tests/test_tiering.py``: tiered decoding (hot levels through the
policy, cold levels host-gathered and prefetched) is bit-identical to the
port's untiered :func:`beam_search` at every split, with and without the
compressed slab and candidate topk, and its tokens and scores equal JAX's
``tiered_beam_search`` on the same table; the budget split, byte accounting,
host gather and pregathered scatter equal the reference's.  Also the
prefetch retry and terminal-fault test of ``tests/test_reliability.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.constraints.tiering import TieredTrie as JaxTieredTrie
from repro.constraints.tiering import tiered_beam_search as jax_tiered_search
from repro.constraints.tiering import vntk_pregathered as jax_pregathered
from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro_torch.constraints import (
    ConstraintStore,
    TieredTrie,
    TriePrefetcher,
    tiered_beam_search,
)
from repro_torch.constraints.tiering import vntk_pregathered
from repro_torch.convert import transition_matrix_from_numpy
from repro_torch.core.beam_search import beam_search
from repro_torch.core.vntk import vntk_reference_scatter
from repro_torch.decoding import DecodePolicy
from repro_torch.observability import MetricsRegistry
from repro_torch.reliability import (
    FaultInjector,
    FaultSpec,
    InjectedFault,
    active_injector,
)
from conftest import make_sids

V, L = 23, 6


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    sids = np.unique(make_sids(rng, 200, V, L, clustered=True), axis=0)
    jtm = JaxTransitionMatrix.from_sids(sids, V, dense_d=1)
    tm = transition_matrix_from_numpy(jtm, device="cpu")
    table = rng.normal(size=(L, V, V)).astype(np.float32)
    return sids, jtm, tm, table


def table_logits_fn(table):
    t = torch.from_numpy(table)

    def fn(carry, last, step):
        return t[step][last.long()], carry
    return fn


def run_untiered(tm, table, policy, batch=3, beams=5):
    state, _ = beam_search(table_logits_fn(table), None, batch, beams, L,
                           policy)
    return state.tokens.numpy(), state.scores.numpy()


# ---------------------------------------------------------------------------
# bit-identity across every split point x compressed x topk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("topk", [False, True])
@pytest.mark.parametrize("hot_steps", [1, 3, L])
def test_tiered_search_bit_identical(corpus, compressed, topk, hot_steps):
    _, jtm, tm, table = corpus
    want_t, want_s = run_untiered(
        tm, table, DecodePolicy.static(tm, topk=topk, compressed=compressed))
    tiered = TieredTrie.from_matrix(tm, hot_steps=hot_steps)
    assert tiered.hot_steps == max(hot_steps, tm.dense_d)
    state, _ = tiered_beam_search(
        table_logits_fn(table), None, 3, 5, L, tiered,
        policy=tiered.hot_policy(topk=topk, compressed=compressed))
    np.testing.assert_array_equal(state.tokens.numpy(), want_t)
    np.testing.assert_array_equal(state.scores.numpy(), want_s)
    # and the reference's tiered search on the same table: tokens equal,
    # scores within the log-softmax's rtol 1e-6 (torch and XLA reduce the
    # log-sum-exp in different orders)
    jt = JaxTieredTrie.from_matrix(jtm, hot_steps=hot_steps)
    jstate, _ = jax_tiered_search(
        lambda c, last, step: (jnp.asarray(table)[step][last], c), None, 3, 5,
        L, jt, policy=jt.hot_policy(topk=topk, compressed=compressed))
    np.testing.assert_array_equal(want_t, np.asarray(jstate.tokens))
    np.testing.assert_allclose(want_s, np.asarray(jstate.scores), rtol=1e-6)


def test_hot_policy_holds_no_full_edges(corpus):
    """The hot slab owns a storage of exactly the hot prefix: a torch slice
    would keep the whole edge tensor alive."""
    _, _, tm, _ = corpus
    tiered = TieredTrie.from_matrix(tm, hot_steps=3)
    cut = tiered.cold_base
    for pol in (tiered.hot_policy(), tiered.hot_policy(compressed=True)):
        sparse = pol.backends[-1]
        e = sparse.tm.edges
        assert e.shape[0] == cut
        assert e.untyped_storage().nbytes() == cut * 8
        assert (e.untyped_storage().data_ptr()
                != tm.edges.untyped_storage().data_ptr())
    slab = tiered.hot_policy(compressed=True).backends[-1].slab
    assert slab.tok_delta.untyped_storage().nbytes() == (
        cut * slab.tok_delta.element_size())


def test_prefetcher_reuse_across_searches(corpus):
    """A long-lived prefetcher must not leak state between searches."""
    _, _, tm, table = corpus
    want_t, want_s = run_untiered(tm, table, DecodePolicy.static(tm))
    tiered = TieredTrie.from_matrix(tm, hot_steps=2)
    with TriePrefetcher(tiered) as pf:
        for _ in range(2):
            state, _ = tiered_beam_search(
                table_logits_fn(table), None, 3, 5, L, tiered, prefetcher=pf)
            np.testing.assert_array_equal(state.tokens.numpy(), want_t)
            np.testing.assert_array_equal(state.scores.numpy(), want_s)
        assert [t["step"] for t in pf.timings] == list(range(2, L)) * 2


# ---------------------------------------------------------------------------
# split selection + byte accounting
# ---------------------------------------------------------------------------
def test_budget_driven_split_and_tier_bytes(corpus):
    _, jtm, tm, _ = corpus
    edges_nb = tm.edges.numel() * tm.edges.element_size()
    fixed = tm.nbytes() - edges_nb
    assert fixed == jtm.nbytes() - np.asarray(jtm.edges).nbytes
    full = TieredTrie.from_matrix(tm)
    assert full.hot_steps == L and full.edges_cold.shape[0] == 0
    assert full.tier_bytes()["host_bytes"] == 0
    tiny = TieredTrie.from_matrix(tm, hbm_budget=fixed)
    assert tiny.hot_steps == tm.dense_d
    budget = fixed + edges_nb // 2
    mid = TieredTrie.from_matrix(tm, hbm_budget=budget)
    tb = mid.tier_bytes()
    assert tm.dense_d <= mid.hot_steps < L
    assert tb["hbm_bytes"] <= budget
    deeper = int(mid.blocks.edge_offsets[mid.hot_steps + 1]) * 8
    assert fixed + deeper > budget
    assert tb["cold_base"] * 8 + tb["host_bytes"] == tm.n_edges * 8
    # every number equals the reference's on the same matrix and budgets
    for kw in ({}, dict(hbm_budget=fixed), dict(hbm_budget=budget),
               dict(hot_steps=1), dict(hot_steps=4)):
        got = TieredTrie.from_matrix(tm, **kw)
        want = JaxTieredTrie.from_matrix(jtm, **kw)
        assert got.tier_bytes() == want.tier_bytes(), kw
        np.testing.assert_array_equal(got.edges_cold, want.edges_cold)
        np.testing.assert_array_equal(got.row_pointers_host,
                                      want.row_pointers_host)


def _level_nodes(tiered, step, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = (int(tiered.blocks.state_offsets[step]),
              int(tiered.blocks.state_offsets[step + 1]))
    return rng.integers(lo, hi, size=(n,))


def test_gather_cold_matches_oracle_window(corpus):
    """The host gather equals the zero-filled window the device step reads,
    rows straddling the hot/cold boundary or the slab end included, and the
    reference's gather."""
    _, jtm, tm, _ = corpus
    tiered = TieredTrie.from_matrix(tm, hot_steps=2)
    jt = JaxTieredTrie.from_matrix(jtm, hot_steps=2)
    step = 3
    bmax = max(tm.bmax_for_step(step), 1)
    nodes = _level_nodes(tiered, step, 9, 5)
    g, lens = tiered.gather_cold(nodes, step)
    rp = tm.row_pointers.numpy().astype(np.int64)
    edges = tm.edges.numpy()
    for i, n in enumerate(nodes):
        assert lens[i] == rp[n + 1] - rp[n]
        for j in range(bmax):
            e = rp[n] + j
            want = (edges[e] if tiered.cold_base <= e < tm.n_edges
                    else np.zeros(2, np.int32))
            np.testing.assert_array_equal(g[i, j], want, err_msg=f"{i},{j}")
    jg, jlens = jt.gather_cold(nodes, step)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(lens, jlens)
    with pytest.raises(ValueError, match="hot"):
        tiered.gather_cold(nodes, 0)


def test_vntk_pregathered_matches_reference(corpus):
    _, _, tm, _ = corpus
    tiered = TieredTrie.from_matrix(tm, hot_steps=2)
    step = 4
    bmax = max(tm.bmax_for_step(step), 1)
    nodes = _level_nodes(tiered, step, 7, 6).astype(np.int32)
    lp = np.random.default_rng(6).normal(size=(7, V)).astype(np.float32)
    g, lens = tiered.gather_cold(nodes, step)
    got_lp, got_nx = vntk_pregathered(torch.from_numpy(lp),
                                      torch.from_numpy(g),
                                      torch.from_numpy(lens), V)
    want_lp, want_nx = vntk_reference_scatter(
        torch.from_numpy(lp), torch.from_numpy(nodes), tm.row_pointers,
        tm.edges, bmax, V)
    np.testing.assert_array_equal(got_lp.numpy(), want_lp.numpy())
    np.testing.assert_array_equal(got_nx.numpy(), want_nx.numpy())
    j_lp, j_nx = jax_pregathered(jnp.asarray(lp), jnp.asarray(g),
                                 jnp.asarray(lens), V)
    np.testing.assert_array_equal(got_lp.numpy(), np.asarray(j_lp))
    np.testing.assert_array_equal(got_nx.numpy(), np.asarray(j_nx))


# ---------------------------------------------------------------------------
# guard rails
# ---------------------------------------------------------------------------
def test_tiering_rejects_stacked_and_unknown_impl(corpus):
    _, _, tm, _ = corpus
    store = ConstraintStore.from_matrices([tm, tm], device="cpu")
    with pytest.raises(NotImplementedError, match="single TransitionMatrix"):
        TieredTrie.from_matrix(store)
    tiered = TieredTrie.from_matrix(tm, hot_steps=2)
    with pytest.raises(ValueError, match="pallas"):
        tiered.hot_policy(impl="pallas")
    assert tiered.hot_policy(impl="plain").backends[-1].impl == "plain"


# ---------------------------------------------------------------------------
# prefetcher: retry inside the overlap window (tests/test_reliability.py)
# ---------------------------------------------------------------------------
def test_prefetch_retry_bit_identical_and_terminal_surfaces():
    rng = np.random.default_rng(0)
    Vr, Lr = 16, 4
    tm = transition_matrix_from_numpy(JaxTransitionMatrix.from_sids(
        make_sids(rng, 50, Vr, Lr), Vr, dense_d=0), device="cpu")
    tiered = TieredTrie.from_matrix(tm, hot_steps=1)
    nodes = rng.integers(1, tm.n_states, size=6).astype(np.int32)
    g_ref, l_ref = tiered.gather_cold(nodes, 1)
    metrics = MetricsRegistry()
    with TriePrefetcher(tiered, metrics=metrics) as pf:
        inj = FaultInjector([
            FaultSpec("tiering.host_fetch", mode="always", max_fires=2)])
        with active_injector(inj):
            g, lens = pf.prefetch(nodes, 1).result(timeout=30.0)
        np.testing.assert_array_equal(g.numpy(), g_ref)
        np.testing.assert_array_equal(lens.numpy(), l_ref)
        assert metrics.counter("tiering_fetch_retries_total").total() == 2
        with active_injector(FaultInjector(
                [FaultSpec("tiering.host_fetch", mode="always")])):
            fut = pf.prefetch(nodes, 1)
            with pytest.raises(InjectedFault):
                fut.result(timeout=30.0)  # search stops; no fallback
