"""Port kernels on the card: tests marked ``gpu`` skip without one.

They import neither JAX nor the reference (a card's machine may have
neither), so they run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` holds every kernel against its plain version at the
main paths' shapes; these are the quick checks of the EmbeddingBag
dispatch and launch counting, for one table and for a group, of the VNTK
topk kernel's two routes (a warp per row up to bmax 32, a block per row
above) for each of its eight instantiations, and of the VNTK mask kernel's
two paths (one warp holds the slots up to bmax 32, the block scatters them
above) for each of its eight, with their 16-byte and scalar loads and
stores.  The §5.2 baselines have no kernel: their masks on CUDA tensors
must equal their masks on the CPU, and an unconstrained beam search runs on
the card with no VNTK launch.  A small batch engine serves on the card
through a hot and a cold swap that an ``AsyncRefresher`` builds on its own
stream, and a CUDA out-of-memory error in the refresher's build fails its
future while the old store keeps serving.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.constraints import (
    AsyncRefresher,
    CatalogDelta,
    ConstraintRegistry,
    ConstraintStore,
    ItemCatalog,
    category_allowlist,
    freshness_window,
)
from repro_torch.core import baselines
from repro_torch.core.beam_search import beam_search
from repro_torch.core.compressed_slab import CompressedSlab
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.core.trie import build_flat_trie
from repro_torch.core.vntk import NEG_INF
from repro_torch.decoding import DecodePolicy
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ops
from repro_torch.kernels import vntk as kv
from repro_torch.models import transformer
from repro_torch.observability import compile_events
from repro_torch.serving import GenerativeRetriever, RequestQueue, ServingEngine


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _inputs(rng, B, K, D, dtype, R=200):
    table = torch.from_numpy(rng.normal(size=(R + 1, D)).astype(np.float32))
    table[R] = 0.0  # sentinel row
    idx = rng.integers(0, R + 1, size=(B, K)).astype(np.int32)
    idx[::4, 0] = -1  # out of range on both sides: clamped
    idx[1::4, -1] = 10_000
    return table.to(dtype).cuda(), torch.from_numpy(idx).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,D,dtype,mode", [
    (512, 1, 32, torch.float32, "sum"), (5, 7, 10, torch.bfloat16, "sum"),
    (64, 3, 1, torch.float32, "mean")])
def test_bag_kernel_equals_plain_on_the_card(rng, B, K, D, dtype, mode):
    _card()
    t, i = _inputs(rng, B, K, D, dtype)
    n = bag.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(t, i, mode)  # a CUDA tensor launches the kernel
    assert bag.LAUNCHES["embedding_bag"] == n + 1
    want = ops.embedding_bag(t, i, mode, impl="plain")
    assert bag.LAUNCHES["embedding_bag"] == n + 1
    if mode == "sum":  # both add the K rows in the same order
        assert torch.equal(got, want)
    else:  # torch on the card divides by K as a product with 1/K
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_bag_kernel_reads_a_feature_column_in_place(rng):
    """A (B, F, K) batch's column has a bag stride of F*K: read in place."""
    _card()
    t, _ = _inputs(rng, 1, 1, 8, torch.float32)
    sparse = torch.from_numpy(
        rng.integers(0, 201, size=(33, 5, 2)).astype(np.int32)).cuda()
    got = bag.embedding_bag_cuda(t, sparse[:, 3, :])
    assert torch.equal(got, bag.embedding_bag_plain(t, sparse[:, 3, :]))


def _group(rng, F, B, K, D, dtype, offset=0):
    """F seeded tables (R_f+1, D) on the card, ``offset`` elements into
    their storage, and (B, F, K) ids with some out of range."""
    tables = []
    for r in rng.integers(20, 300, size=F):
        flat = torch.from_numpy(
            rng.normal(size=offset + (r + 1) * D).astype(np.float32))
        t = flat.to(dtype).cuda()[offset:].view(r + 1, D)
        t[r] = 0.0
        tables.append(t)
    idx = rng.integers(0, 20, size=(B, F, K)).astype(np.int32)
    idx[::5, :, 0] = -7  # clamped into each table's [0, R_f]
    idx[1::5, :, -1] = 400
    return tables, torch.from_numpy(idx).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("B,F,K,D,dtype,mode,path", [
    (512, 3, 1, 32, torch.float32, "sum", "v16"),
    (40, 4, 4, 32, torch.bfloat16, "sum", "v16"),
    (20, 2, 3, 128, torch.float32, "mean", "v16"),
    (64, 70, 1, 1, torch.float32, "sum", "scalar"),
    (33, 5, 7, 10, torch.bfloat16, "mean", "scalar")])
def test_grouped_launch_equals_plain_on_the_card(rng, B, F, K, D, dtype, mode,
                                                 path):
    _card()
    tables, ids = _group(rng, F, B, K, D, dtype)
    assert bag.load_path(tables) == path
    n = bag.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag_grouped(tables, ids, mode)
    assert bag.LAUNCHES["embedding_bag"] == n + -(-F // bag.MAX_TABLES)
    want = ops.embedding_bag_grouped(tables, ids, mode, impl="plain")
    assert bag.LAUNCHES["embedding_bag"] == n + -(-F // bag.MAX_TABLES)
    assert got.shape == (B, F, D) and got.is_contiguous()
    if mode == "sum":  # both add the K rows in the same order
        assert torch.equal(got, want)
    elif dtype == torch.float32:  # torch on the card divides by K as a
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)  # * 1/K
    else:  # ... which may round a bf16 mean the other way: one ulp
        g, w = got.float(), want.float()
        ulp = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((g - w).abs() <= ulp).all())


@pytest.mark.gpu
def test_grouped_misaligned_view_takes_the_scalar_path(rng):
    """Tables 4 bytes off a 16-byte boundary: still the kernel, one launch,
    on its scalar path."""
    _card()
    tables, ids = _group(rng, 3, 100, 1, 32, torch.float32, offset=1)
    assert all(t.data_ptr() % 16 == 4 for t in tables)
    assert bag.load_path(tables) == "scalar"
    n = bag.LAUNCHES["embedding_bag"]
    got = bag.embedding_bag_grouped_cuda(tables, ids)
    assert bag.LAUNCHES["embedding_bag"] == n + 1
    assert torch.equal(got, bag.embedding_bag_grouped_plain(tables, ids))


def _vntk_args(rng, stacked, compressed, bmax, fused, nb=37, V=64,
               topk=True):
    """A VNTK function's arguments on small tries over V tokens (dense_d =
    0; two as a store when ``stacked``): rows at the sink, at the root (V
    children) and on level 1 (~30-40 children at V = 64), logits or
    log-probs with columns at NEG_INF and -inf; width V for topk."""
    fts = [build_flat_trie(rng.integers(0, V, (n, 3)), V, dense_d=0)
           for n in (3000, 1500)[:2 if stacked else 1]]
    mats = [TransitionMatrix.from_flat_trie(f, device="cuda") for f in fts]
    tables = (ConstraintStore.from_matrices(mats, device="cuda") if stacked
              else mats[0])
    ids = rng.integers(0, len(fts), nb).astype(np.int32)
    nodes = np.array([rng.integers(fts[k].level_offsets[1],
                                   fts[k].level_offsets[2]) for k in ids],
                     np.int32)
    nodes[::5], nodes[1::5] = 0, 1  # the sink and the root
    x = torch.from_numpy(rng.normal(size=(nb, V)).astype(np.float32) * 4)
    x[:, ::7], x[:, 3::11] = -float("inf"), NEG_INF
    values = (x if fused else torch.log_softmax(x, -1)).cuda()
    head = [values, torch.from_numpy(nodes).cuda()]
    if stacked:
        head.append(torch.from_numpy(ids).cuda())
    if compressed:
        slab = CompressedSlab.build(tables)
        csr = [tables.row_pointers, slab.tok_delta, slab.base_for_step(1)]
    else:
        csr = [tables.row_pointers, tables.edges]
    return head + csr + [bmax, V] + ([V] if topk else []) + [fused]


def _launch_once(kernel, fused, args):
    """The kernel's outputs and its plain version's; one launch between."""
    name = kv.counter_name(kernel, fused)
    n = kv.LAUNCHES[name]
    got = getattr(kv, f"{kernel}_cuda")(*args)
    assert kv.LAUNCHES[name] == n + 1
    want = getattr(kv, f"{kernel}_plain")(*args)
    assert kv.LAUNCHES[name] == n + 1
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kernel", [
    "vntk_topk", "vntk_stacked_topk", "vntk_compressed_topk",
    "vntk_stacked_compressed_topk"])
@pytest.mark.parametrize("bmax,path", [(32, "warp"), (33, "block")])
def test_topk_routes_equal_plain_on_the_card(rng, kernel, fused, bmax, path):
    """Rows cut at bmax = 32 take the warp route, at 33 the block route:
    each launches once and equals the plain version (tokens and next
    states exactly, scores exactly or, fused, within 1e-5)."""
    _card()
    assert kv.topk_path(bmax) == path
    args = _vntk_args(rng, "stacked" in kernel, "compressed" in kernel, bmax,
                      fused)
    got, want = _launch_once(kernel, fused, args)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    if fused:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got[0], want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [
    "vntk_topk", "vntk_stacked_topk", "vntk_compressed_topk",
    "vntk_stacked_compressed_topk"])
def test_topk_warp_route_reads_unaligned_logit_rows(rng, kernel):
    """Fused logit rows 4 bytes off a 16-byte boundary (and V % 4 != 0):
    the warp route's scalar loads, equal to the plain version."""
    _card()
    for offset, V in ((1, 64), (0, 62)):
        args = _vntk_args(rng, "stacked" in kernel, "compressed" in kernel, 32,
                          True, V=V)
        wide = torch.full((args[0].shape[0], V + offset), -3.0,
                          device="cuda")
        wide[:, offset:] = args[0]
        args[0] = wide[:, offset:]
        got = getattr(kv, f"{kernel}_cuda")(*args)
        want = getattr(kv, f"{kernel}_plain")(*args)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)


def _assert_mask_equal(got, want, fused):
    """Next states exactly; scores exactly or, fused, within 1e-5."""
    assert torch.equal(got[1], want[1])
    if fused:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got[0], want[0])


MASKS = ["vntk_mask", "vntk_stacked_mask", "vntk_compressed_mask",
         "vntk_stacked_compressed_mask"]


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kernel", MASKS)
@pytest.mark.parametrize("bmax,path", [(32, "warp"), (33, "block")])
def test_mask_paths_equal_plain_on_the_card(rng, kernel, fused, bmax, path):
    """Rows cut at bmax = 32 are held by one warp, at 33 scattered by the
    block: each launches once and equals the plain version."""
    _card()
    assert kv.mask_path(bmax) == path
    args = _vntk_args(rng, "stacked" in kernel, "compressed" in kernel, bmax,
                      fused, topk=False)
    _assert_mask_equal(*_launch_once(kernel, fused, args), fused)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", MASKS)
def test_mask_reads_unaligned_logit_rows(rng, kernel):
    """Fused logit rows 4 bytes off a 16-byte boundary (the scalar loads)
    and V % 4 != 0 (scalar loads and the scalar fill), on both paths."""
    _card()
    for offset, V, fused in ((1, 64, True), (0, 62, True), (0, 62, False)):
        for bmax in (32, 33):
            args = _vntk_args(rng, "stacked" in kernel, "compressed" in kernel,
                              bmax, fused, V=V, topk=False)
            wide = torch.full((args[0].shape[0], V + offset), -3.0,
                              device="cuda")
            wide[:, offset:] = args[0]
            args[0] = wide[:, offset:]
            _assert_mask_equal(*_launch_once(kernel, fused, args), fused)


BASELINES = {
    "ppv_exact": lambda sids, V, dev: baselines.PPVBaseline(sids, V,
                                                            device=dev),
    "ppv_approx": lambda sids, V, dev: baselines.PPVBaseline(
        sids, V, exact=False, top_k=50, device=dev),
    "hash_bitmap": lambda sids, V, dev: baselines.HashBitmapBaseline(
        sids, V, log2_bits=14, device=dev),
    "cpu_trie": lambda sids, V, dev: baselines.CpuTrieBaseline(sids, V),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_mask_on_the_card_equals_the_cpu(rng, name):
    """Tables built on the card equal the CPU's; so do masks and next
    states at every step, on walked and random prefixes."""
    _card()
    V, L = 64, 5
    sids = rng.integers(0, V, size=(3000, L))
    cpu, card = (BASELINES[name](sids, V, dev) for dev in ("cpu", "cuda"))
    for table in ("sids_sorted", "keys", "bitmap"):
        if hasattr(cpu, table):
            assert getattr(card, table).is_cuda
            assert torch.equal(getattr(card, table).cpu(), getattr(cpu, table))
    pf = torch.from_numpy(np.concatenate(
        [sids[rng.integers(0, 3000, 40)], rng.integers(0, V, (40, L))]
    ).astype(np.int32))
    for step in range(L):
        lp = torch.from_numpy(rng.normal(size=(80, V)).astype(np.float32))
        lp[::3] = torch.from_numpy(rng.integers(-2, 2, (27, V)).astype(
            np.float32))  # ties for the approximate top-k
        want = cpu.mask_step(lp, pf, step)
        got = card.mask_step(lp.cuda(), pf.cuda(), step)
        assert got[0].is_cuda and got[1].is_cuda
        assert torch.equal(got[0].cpu(), want[0]), step
        assert torch.equal(got[1].cpu(), want[1]), step


@pytest.mark.gpu
def test_unconstrained_beam_search_on_the_card_launches_no_kernel(rng):
    _card()
    table = torch.from_numpy(rng.normal(size=(4, 32, 32)).astype(np.float32))
    runs = {}
    for dev in ("cpu", "cuda"):
        tbl = table.to(dev)
        kv.reset_launches()
        runs[dev], _ = beam_search(
            lambda c, last, s: (tbl[s][last.long()], c), None, 2, 6, 4,
            DecodePolicy.unconstrained(), device=dev)
        assert not any(kv.LAUNCHES.values())
    assert runs["cuda"].tokens.is_cuda
    assert torch.equal(runs["cuda"].tokens.cpu(), runs["cpu"].tokens)
    assert torch.equal(runs["cuda"].nodes.cpu(), runs["cpu"].nodes)
    torch.testing.assert_close(runs["cuda"].scores.cpu(), runs["cpu"].scores,
                               rtol=1e-6, atol=1e-6)


def _catalog(rng, n, V, L):
    sids = np.unique(rng.integers(0, V, (n, L)), axis=0)
    return ItemCatalog(sids=sids, age_days=rng.uniform(0, 60, len(sids)),
                       category=rng.integers(0, 4, len(sids)))


def _registry(V, headroom, streams=None):
    """Two slots; ``streams`` collects the stream each predicate ran on."""
    def fresh(cat):
        if streams is not None:
            streams.append((threading.current_thread().name,
                            torch.cuda.current_stream()))
        return cat.age_days <= 45
    reg = ConstraintRegistry(V, headroom=headroom)  # on the card
    reg.register("fresh", fresh)
    reg.register("cats", category_allowlist(0, 1, 2))
    return reg


@pytest.mark.gpu
def test_engine_hot_and_cold_swap_on_the_card(rng):
    _card()
    V, L = 32, 4
    cfg = TransformerConfig(name="gr-tiny", n_layers=2, d_model=32,
                            n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=34,
                            dtype="float32", tie_embeddings=True)
    params = transformer.init_params(cfg, 0, device="cuda")
    streams = []
    reg = _registry(V, headroom=0.5, streams=streams)
    cat = _catalog(rng, 120, V, L)
    store = reg.build(cat)
    assert store.device.type == "cuda"
    eng = ServingEngine(params, cfg, 4, 24, registry=reg,
                        retriever=GenerativeRetriever(params, cfg, store, L, V,
                                                      beam_size=4))

    def serve(n, version):
        q = RequestQueue()
        rids = [q.submit(rng.integers(0, 34, (8,)), n_tokens=L,
                         constraint_id=i % 2) for i in range(n)]
        kv.reset_launches()
        c0 = compile_events()
        results = eng.serve(q)
        assert set(results) == set(rids) and len(q) == 0
        sets = [{tuple(r) for r in reg.slot_sids(s).astype(np.int64)}
                for s in range(2)]
        for r in results.values():
            assert r["store_version"] == version
            for sid, score in zip(r["sids"], r["scores"]):
                if score > NEG_INF / 2:
                    assert tuple(int(t) for t in sid) in sets[r["constraint_id"]]
        # the stacked topk kernel on each of the L - dense_d sparse levels
        batches = -(-n // 4)
        assert kv.LAUNCHES["vntk_stacked_topk"] == batches * (L - 2)
        assert sum(kv.LAUNCHES.values()) == batches * (L - 2)
        return compile_events() - c0

    assert serve(6, 1) == 1  # the first batch specializes
    with AsyncRefresher(reg) as ref:
        delta = CatalogDelta(removed_sids=cat.sids[:10],  # fits the envelope
                             added=_catalog(rng, 5, V, L))
        assert ref.apply_delta_async(delta).result(timeout=120) == 2
        assert serve(6, 2) == 0  # hot
        assert ref.swap_async(_catalog(rng, 900, V, L)).result(  # outgrows it
            timeout=120) == 3
        assert serve(5, 3) == 1  # cold: exactly one
        assert serve(3, 3) == 0
    assert reg.envelope_generation == 2 and eng.cold_swaps == 1
    assert reg.current()[0].device.type == "cuda"
    # the predicate ran in the refresher's worker for the delta's added
    # items and for the snapshot, on a stream of the worker's own
    worker = [st for name, st in streams if name == "constraint-refresh"]
    assert len(worker) == 2
    for st in worker:
        assert st != torch.cuda.default_stream()


@pytest.mark.gpu
def test_refresher_oom_on_the_card_fails_the_future(rng):
    """A CUDA out-of-memory error while the back buffer is built resolves
    the future with it; the old store keeps serving and no half-built
    buffer stays allocated."""
    _card()
    V, L = 2048, 3  # dense l1 tables of V x V: 16 MB a slot
    reg = _registry(V, headroom=0.5)
    store = reg.build(_catalog(rng, 4000, V, L))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    before = torch.cuda.memory_allocated()
    # room for what is cached now plus 8 MB: the back buffer needs ~66 MB
    torch.cuda.set_per_process_memory_fraction(
        (torch.cuda.memory_reserved() + (8 << 20)) / total)
    try:
        with AsyncRefresher(reg) as ref:
            fut = ref.apply_delta_async(CatalogDelta(
                removed_sids=reg.slot_sids(0)[:5].astype(np.int64)))
            with pytest.raises(torch.OutOfMemoryError):
                fut.result(timeout=120)
            assert ref.failed == 1
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert reg.current() == (store, 1)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
