"""The port's SPMD path across ranks: worlds of 2 and 4 processes (gloo).

Two worlds are spawned with ``torch.multiprocessing`` and a ``FileStore``
under ``tmp_path``; their ranks run ``tests/torch_spmd_workers.py`` (the
port only, no JAX) on the meshes ``(2, 1)`` and ``(1, 2)``, and ``(2, 2)``
and ``(1, 4)``, and write their outputs as ``.npy``.  This process holds
them against the reference (DESIGN.md §6):

  * the row-sharded VNTK steps (mask and top-k, plain and compressed,
    single and stacked) equal the reference's replicated
    ``vntk_xla``/``vntk_topk_reference`` and twins bit for bit, on every
    trie row, among them rows whose bursts straddle a shard boundary, and
    on log-probs full of ties;
  * each rank holds ``E_pad / ms`` edge rows;
  * ``spmd_beam_search`` over the reference fuzzer's cases, both
    placements, top-k on and off: tokens equal to the reference's
    ``beam_search`` and scores within the golden traces' 1e-6 (the two
    frameworks' log-softmax may differ in the last ulp), and tokens and
    scores bit-equal to the port's single-device ``beam_search``, the
    reference's own SPMD contract;
  * the row-sharded top-k search issues ONE all-reduce per sparse step, of
    ``(nb, ms, C)`` x 12 bytes plus the ``(nb, C)`` counts;
  * ``SpmdRetriever`` bit-equal to ``GenerativeRetriever`` on each rank's
    rows, and within 1e-4 of it on the whole batch (another batch size
    may sum its matmuls in another order).
"""
import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.constraints import ConstraintStore as JaxStore
from repro.core import TransitionMatrix as JaxTM
from repro.core import beam_search as jax_beam_search
from repro.core import vntk as jv
from repro.core.compressed_slab import CompressedSlab as JaxSlab
from repro.decoding import DecodePolicy as JaxPolicy
from repro_torch.core import TransitionMatrix
from repro_torch.core.beam_search import beam_search
from repro_torch.core.vntk import candidate_width
from repro_torch.decoding import DecodePolicy
from conftest import make_sids
from test_differential_fuzz import FUZZ_SEEDS, make_case
from torch_spmd_workers import MESHES, run_world

V, L, DENSE_D, STEP, M = 16, 4, 1, 2, 5
SHARDED = ("1x2", "2x2", "1x4")
ALL = ("2x1", "1x2", "2x2", "1x4")


def _straddlers(tm, nodes, ms):
    """Whether some node's valid burst at STEP crosses a row-block edge."""
    rp = np.asarray(tm.row_pointers).astype(np.int64)
    first = rp[nodes]
    n = np.minimum(rp[nodes + 1] - first, tm.bmax_for_step(STEP))
    rows_local = -(-tm.edges.shape[0] // ms)
    return ((n > 1) & (first // rows_local
                       != (first + n - 1) // rows_local)).any()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    for n in range(150, 250):  # the first corpus with straddling bursts
        sids1 = np.unique(make_sids(rng, n, V, L, clustered=True), axis=0)
        tm = JaxTM.from_sids(sids1, V, dense_d=DENSE_D)
        if all(_straddlers(tm, np.arange(tm.n_states), ms) for ms in (2, 4)):
            break
    sids2 = np.unique(make_sids(rng, 60, V, L, clustered=True), axis=0)
    n_states = tm.n_states
    nodes = np.concatenate([np.arange(n_states),
                            rng.integers(0, n_states, 40)]).astype(np.int32)
    inp = dict(V=V, dense_d=DENSE_D, step=STEP, width=candidate_width(M, V),
               sids1=sids1, sids2=sids2, nodes=nodes,
               lp=rng.integers(-4, 0, (nodes.size, V)).astype(np.float32),
               cids=(rng.random(nodes.size) < 0.5).astype(np.int32),
               hist=rng.integers(0, 40, (4, 8)), seeds=FUZZ_SEEDS[:3])
    for seed in inp["seeds"]:
        case = make_case(seed)
        inp[f"case{seed}_sids"] = case["sids"]
        inp[f"case{seed}_table"] = np.array(case["table"])
        inp[f"case{seed}_meta"] = np.array(
            [case["V"], case["L"], case["dense_d"]])
    return inp


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{mesh tag: [rank outputs]} of both worlds."""
    out = {}
    for world_size in MESHES:
        root = tmp_path_factory.mktemp(f"world{world_size}")
        np.savez(root / "inputs.npz", **inputs)
        mp.spawn(run_world, args=(world_size, str(root)), nprocs=world_size,
                 join=True)
        per_rank = [dict(np.load(root / f"rank{r}.npz"))
                    for r in range(world_size)]
        for data, model in MESHES[world_size]:
            tag = f"{data}x{model}"
            out[tag] = [{k.split("/", 1)[1]: v for k, v in d.items()
                         if k.startswith(tag + "/")} for d in per_rank]
    return out


def _ms(tag):
    return int(tag.split("x")[1])


@pytest.fixture(scope="module")
def jax_tables(inputs):
    tm = JaxTM.from_sids(inputs["sids1"], V, dense_d=DENSE_D)
    tm2 = JaxTM.from_sids(inputs["sids2"], V, dense_d=DENSE_D)
    return tm, JaxStore.from_matrices([tm2, tm], headroom=0.2)


def _reference(inputs, jax_tables, kind, name):
    tm, store = jax_tables
    lp, nodes, cids = inputs["lp"], inputs["nodes"], inputs["cids"]
    width = int(inputs["width"])
    obj = tm if kind == "single" else store
    bmax = max(obj.bmax_for_step(STEP), 1)
    slab = JaxSlab.build(obj)
    base = slab.base_for_step(STEP)
    if kind == "single":
        return {
            "mask": lambda: jv.vntk_xla(lp, nodes, tm, bmax),
            "topk": lambda: jv.vntk_topk_reference(
                lp, nodes, tm.row_pointers, tm.edges, bmax, V, width),
            "cmask": lambda: jv.vntk_compressed_reference(
                lp, nodes, tm.row_pointers, slab.tok_delta, base, bmax, V),
            "ctopk": lambda: jv.vntk_compressed_topk_reference(
                lp, nodes, tm.row_pointers, slab.tok_delta, base, bmax, V,
                width),
        }[name]()
    return {
        "mask": lambda: jv.vntk_stacked_xla(lp, nodes, store, bmax, cids),
        "topk": lambda: jv.vntk_stacked_topk_reference(
            lp, nodes, cids, store.row_pointers, store.edges, bmax, V,
            width),
        "cmask": lambda: jv.vntk_stacked_compressed_reference(
            lp, nodes, cids, store.row_pointers, slab.tok_delta, base, bmax,
            V),
        "ctopk": lambda: jv.vntk_stacked_compressed_topk_reference(
            lp, nodes, cids, store.row_pointers, slab.tok_delta, base, bmax,
            V, width),
    }[name]()


@pytest.mark.parametrize("name", ["mask", "topk", "cmask", "ctopk"])
@pytest.mark.parametrize("kind", ["single", "stacked"])
@pytest.mark.parametrize("tag", SHARDED)
def test_row_sharded_vntk_equals_reference(ranks, inputs, jax_tables, tag,
                                           kind, name):
    want = _reference(inputs, jax_tables, kind, name)
    for r, d in enumerate(ranks[tag]):
        for i, w in enumerate(want):
            np.testing.assert_array_equal(
                d[f"{name}_{kind}_{i}"], np.asarray(w),
                err_msg=f"{tag} rank {r} output {i}")


def test_bursts_straddle_shard_boundaries(inputs, jax_tables):
    """The rows checked above include bursts that cross a block edge at
    every shard count, and ties among the log-probs."""
    for ms in (2, 4):
        assert _straddlers(jax_tables[0], inputs["nodes"], ms), ms
    lp = np.sort(inputs["lp"], axis=1)
    assert (lp[:, 1:] == lp[:, :-1]).any(axis=1).all()


@pytest.mark.parametrize("kind", ["single", "stacked"])
@pytest.mark.parametrize("tag", SHARDED)
def test_each_rank_holds_its_block_of_edges(ranks, jax_tables, tag, kind):
    tm, store = jax_tables
    obj = tm if kind == "single" else store
    ms = _ms(tag)
    e_pad = -(-obj.edges.shape[-2] // ms) * ms
    k = 1 if kind == "single" else store.num_sets
    for d in ranks[tag]:
        assert int(d[f"edges_rows_{kind}"]) == e_pad // ms
        assert int(d[f"edges_bytes_{kind}"]) == k * (e_pad // ms) * 2 * 4


@pytest.fixture(scope="module")
def single_searches(inputs):
    """{(seed, topk, B): (reference tokens, scores, port tokens, scores)}."""
    out = {}
    for seed in inputs["seeds"]:
        sids, table = inputs[f"case{seed}_sids"], inputs[f"case{seed}_table"]
        cv, cl, cd = (int(x) for x in inputs[f"case{seed}_meta"])
        jtm = JaxTM.from_sids(sids, cv, dense_d=cd)
        tm = TransitionMatrix.from_sids(sids, cv, dense_d=cd, device="cpu")
        jt, tt = jax.numpy.asarray(table), torch.as_tensor(table)
        for topk in (True, False):
            for B in (2, 4):
                @jax.jit
                def single(pol):
                    state, _ = jax_beam_search(
                        lambda c, last, s: (jt[s][last], c), None, B, M, cl,
                        pol)
                    return state.tokens, state.scores

                wt, ws = single(JaxPolicy.static(jtm, topk=topk))
                state, _ = beam_search(
                    lambda c, last, s: (tt[s][last.long()], c), None, B, M,
                    cl, DecodePolicy.static(tm, impl="plain", topk=topk))
                out[seed, topk, B] = (np.asarray(wt), np.asarray(ws),
                                      state.tokens.numpy(),
                                      state.scores.numpy())
    return out


@pytest.mark.parametrize("topk", [True, False])
@pytest.mark.parametrize("rows", ["replicated", "model"])
@pytest.mark.parametrize("tag", ALL)
def test_spmd_beam_search_matches_single_device(ranks, inputs,
                                                single_searches, tag, rows,
                                                topk):
    B = 2 * int(tag.split("x")[0])
    for seed in inputs["seeds"]:
        wt, ws, pt, ps = single_searches[seed, topk, B]
        key = f"bs{seed}_{rows}_{int(topk)}"
        for r, d in enumerate(ranks[tag]):
            msg = f"seed {seed} rank {r}"
            np.testing.assert_array_equal(d[key + "_tokens"], wt, msg)
            np.testing.assert_allclose(d[key + "_scores"], ws, rtol=1e-6,
                                       err_msg=msg)
            np.testing.assert_array_equal(d[key + "_tokens"], pt, msg)
            np.testing.assert_array_equal(d[key + "_scores"], ps, msg)


@pytest.mark.parametrize("tag", ALL)
def test_collectives_of_the_sharded_topk_search(ranks, inputs, tag):
    """rows='model', top-k: one all-reduce per sparse step of (nb, ms, C)
    key/token/next int32 plus the (nb, C) counts; the replicated placement
    reduces nothing; dp > 1 adds the one all-gather of the results."""
    dp, ms = (int(x) for x in tag.split("x"))
    for seed in inputs["seeds"]:
        cv, cl, cd = (int(x) for x in inputs[f"case{seed}_meta"])
        C = candidate_width(M, cv)
        nb = 2 * M  # B / dp rows of M beams
        for rows in ("replicated", "model"):
            log = ranks[tag][0][f"bs{seed}_{rows}_1_log"]
            reduces = log[log[:, 0] == 1, 1]
            gathers = log[log[:, 0] == 0, 1]
            n_sparse = cl - min(cd, cl) if rows == "model" and ms > 1 else 0
            assert reduces.size == n_sparse, (seed, rows)
            assert (reduces == nb * ms * C * 12 + nb * C * 4).all()
            assert gathers.size == (dp > 1)
            assert (gathers == dp * 2 * M * (cl + 1) * 4).all()


@pytest.mark.parametrize("tag", ALL)
def test_spmd_retriever_equals_generative_retriever(ranks, tag):
    for d in ranks[tag]:
        lo, hi = d["retr_own_rows"]
        np.testing.assert_array_equal(d["retr_spmd_tokens"][lo:hi],
                                      d["retr_own_tokens"])
        np.testing.assert_array_equal(d["retr_spmd_scores"][lo:hi],
                                      d["retr_own_scores"])
        np.testing.assert_array_equal(d["retr_spmd_tokens"],
                                      d["retr_whole_tokens"])
        np.testing.assert_allclose(d["retr_spmd_scores"],
                                   d["retr_whole_scores"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(d["retr_spmd_scores"],
                                      ranks[tag][0]["retr_spmd_scores"])
