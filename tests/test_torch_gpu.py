"""Port kernels on the card: tests marked ``gpu`` skip without one.

They import neither JAX nor the reference (a card's machine may have
neither), so they run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` holds every kernel against its plain version at the main
paths' shapes; these are the quick checks of the EmbeddingBag dispatch and
launch counting, for one table and for a group, of the VNTK topk kernel's
two routes (a warp per row up to bmax 32, a block per row above) for each
of its eight instantiations, of the block route's radix select for each of
its twelve (int16 and int32 slabs) at bmax 33, 2,048 and past 32,768, with
its keys staged and, at 65,536, re-read, and of the VNTK mask kernel's two
paths (one warp holds the slots up to bmax 32, the block scatters them
above) for each of its eight, with their 16-byte and scalar loads and
stores. The §5.2 baselines have no kernel: their masks on CUDA tensors must
equal their masks on the CPU, and an unconstrained beam search runs on the
card with no VNTK launch. A small batch engine serves on the card through a
hot and a cold swap that an ``AsyncRefresher`` builds on its own stream,
and a CUDA out-of-memory error in the refresher's build fails its future
while the old store keeps serving; host tables cross to the card through
the store's pinned staging, chunk by chunk, unchanged. The continuous
engine's pieces on the card: the level-free mask over a dense_d=0 trie and
store (the mask kernel's block path, at a root row of 512 slots and more,
and at a bmax above V under the store's headroom) against its plain
version, ``shared_mask_step`` against the per-level step,
``paged_decode_step`` against ``decode_step``, and the engine against
``ServingEngine`` at equal shapes, bit for bit. Tiering: the tiered search
with the kernels on a hot slab of exactly ``cold_base`` rows, bit-equal to
the untiered search, and the prefetcher's pinned staging;
``gr_decode_step`` in bf16 against float32 on the CPU; ``StepTimer`` on the
card; ``SpmdRetriever`` in a world of one over nccl, bit-equal to
``GenerativeRetriever``.  The decode-attention kernel against its plain
version at both cells' shapes, on both of its routes, with the masks,
dtypes and head shapes the port's callers give it; a row alone equals the
row among many, bit for bit; one launch a call, ``n_layers * (L - 1)`` a
retrieve."""
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
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ops
from repro_torch.kernels import vntk as kv
from repro_torch.models import kvcache, transformer
from repro_torch.observability import compile_events
from repro_torch.serving import GenerativeRetriever, RequestQueue, ServingEngine
from repro_torch.serving.continuous import ContinuousServingEngine


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


TOPKS = ["vntk_topk", "vntk_stacked_topk", "vntk_compressed_topk",
         "vntk_stacked_compressed_topk"]
# (V, SIDs of length 2) of the block route's tries: the root row holds
# nearly every token, so bmax 33 and 2,048 cut it and 32,768 does not; V =
# 32,768 is the largest int16 slab, V = 40,000 and 65,536 int32 ones, and
# 65,536 keys pass a block's shared memory
BLOCK_TRIES = {2048: 40_000, 32_768: 400_000, 40_000: 480_000,
               65_536: 800_000}


@pytest.fixture(scope="module")
def block_tries():
    """Dense_d=0 tries of BLOCK_TRIES on the card, one matrix and a store
    of two members each, built once (on the first card test that asks)."""
    cache = {}

    def get(V, stacked):
        if (V, stacked) not in cache:
            rng = np.random.default_rng(V)
            fts = [build_flat_trie(rng.integers(0, V, (n, 2)), V, dense_d=0)
                   for n in (BLOCK_TRIES[V], BLOCK_TRIES[V] // 2)]
            mats = [TransitionMatrix.from_flat_trie(f, device="cuda")
                    for f in fts]
            tables = (ConstraintStore.from_matrices(mats, device="cuda")
                      if stacked else mats[0])
            cache[V, stacked] = fts, tables
        return cache[V, stacked]

    return get


def _block_args(rng, get, kernel, fused, bmax, V, width=72, nb=37):
    """A topk function's arguments at the root rows (and, every third row,
    level-1 rows and the sink) of a trie of ``get`` over V tokens; logits
    or log-probs with columns at NEG_INF and -inf."""
    stacked, compressed = "stacked" in kernel, "compressed" in kernel
    fts, tables = get(V, stacked)
    ids = rng.integers(0, len(fts) if stacked else 1, nb).astype(np.int32)
    nodes = np.ones(nb, np.int32)
    for r in range(0, nb, 3):
        off = fts[ids[r]].level_offsets
        nodes[r] = rng.integers(off[1], off[2])
    nodes[::7] = 0
    x = torch.from_numpy(rng.normal(size=(nb, V)).astype(np.float32) * 4)
    x = x.to(torch.bfloat16).float()  # the model's ties
    x[:, ::7], x[:, 3::11] = -float("inf"), NEG_INF
    values = (x if fused else torch.log_softmax(x, -1)).cuda()
    head = [values, torch.from_numpy(nodes).cuda()]
    if stacked:
        head.append(torch.from_numpy(ids).cuda())
    if compressed:
        slab = CompressedSlab.build(tables)
        assert slab.tok_delta.dtype == (torch.int16 if V <= 32_768
                                        else torch.int32)
        csr = [tables.row_pointers, slab.tok_delta, slab.base_for_step(0)]
    else:
        csr = [tables.row_pointers, tables.edges]
    return head + csr + [bmax, V, width, fused]


def _assert_topk_equal(got, want, fused):
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    if fused:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got[0], want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kernel", TOPKS)
@pytest.mark.parametrize("V,bmax", [
    (2048, 33), (2048, 2048), (32_768, 32_768), (40_000, 33),
    (40_000, 40_000), (65_536, 65_536)])
def test_topk_block_route_equals_plain_on_the_card(rng, block_tries, kernel,
                                                   fused, V, bmax):
    """Every block instantiation (fused or not, stacked or not, int2
    pairs, int16 deltas at V <= 32,768 and int32 deltas above) at bmax 33,
    2,048 and >= 32,768 (a root row of every token: past the 19,370
    candidates the first block kernel's shared memory took), and at 65,536,
    whose keys the kernel re-reads in every pass: one launch, equal to the
    plain version, counted as the 1,024-thread instantiation's past 8,192
    slots."""
    _card()
    assert kv.topk_path(bmax) == "block"
    assert kv.topk_staged(bmax) == (bmax < 65_536)
    args = _block_args(rng, block_tries, kernel, fused, bmax, V)
    name = kv.counter_name(kernel, fused)
    n, w = kv.BLOCK_LAUNCHES[name], kv.WIDE_LAUNCHES[name]
    _assert_topk_equal(*_launch_once(kernel, fused, args), fused)
    assert kv.BLOCK_LAUNCHES[name] == n + 1
    assert kv.WIDE_LAUNCHES[name] == w + (bmax > 8192)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kernel", TOPKS)
@pytest.mark.parametrize("V,bmax", [(2048, 2048), (32_768, 32_768)])
def test_topk_block_route_rereads_keys_on_the_card(rng, block_tries, kernel,
                                                   fused, V, bmax):
    """Within ``topk_keys_reread`` the block route stages no keys at widths
    that would stage them, and re-reads them in every pass: equal to the
    plain version; staging resumes after it."""
    _card()
    args = _block_args(rng, block_tries, kernel, fused, bmax, V)
    with kv.topk_keys_reread():
        assert not kv.topk_staged(bmax)
        _assert_topk_equal(*_launch_once(kernel, fused, args), fused)
    assert kv.topk_staged(bmax)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kernel", TOPKS)
def test_topk_block_route_rounds_and_unaligned_rows_on_the_card(
        rng, block_tries, kernel, fused):
    """A width of V = 2,048 (eight rounds of the selection) and, fused, a
    logit row off 16-byte alignment (the scalar loads): equal to the plain
    version."""
    _card()
    wide = _block_args(rng, block_tries, kernel, fused, 2048, 2048,
                       width=2048)
    _assert_topk_equal(*_launch_once(kernel, fused, wide), fused)
    if fused:
        args = _block_args(rng, block_tries, kernel, fused, 2048, 2048)
        off = torch.full((args[0].shape[0], 2049), -3.0, device="cuda")
        off[:, 1:] = args[0]
        args[0] = off[:, 1:]
        _assert_topk_equal(*_launch_once(kernel, fused, args), fused)

@pytest.mark.gpu
def test_store_upload_through_pinned_staging_equals_the_host(rng,
                                                             monkeypatch):
    """Host matrices cross to the card through two pinned staging buffers:
    cut to 4 KB (every table in many chunks, each buffer refilled after
    its copy's event), the store built on the card, and ``with_members``
    on it, equal the same stores built on the host, table for table."""
    _card()
    from repro_torch.constraints import store as store_mod

    monkeypatch.setattr(store_mod, "_STAGE_BYTES", 4096)
    mats = [TransitionMatrix.from_flat_trie(
        build_flat_trie(rng.integers(0, 64, (n, 3)), 64, dense_d=1),
        device="cpu") for n in (3000, 1500)]
    for host, card in (
            (ConstraintStore.from_matrices(mats, device="cpu"),
             ConstraintStore.from_matrices(mats, device="cuda")),
            (ConstraintStore.from_matrices(mats, device="cpu").with_members(
                mats[::-1]), ConstraintStore.from_matrices(
                    mats, device="cuda").with_members(mats[::-1]))):
        for f in store_mod._LEAF_FIELDS:
            assert getattr(card, f).is_cuda
            assert torch.equal(getattr(card, f).cpu(), getattr(host, f)), f


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


# ---------------------------------------------------------------------------
# continuous batching on the card
# ---------------------------------------------------------------------------
def _level_free_tables(rng, stacked):
    """A dense_d=0 trie over V = 1024 (root row of ~1024 slots), or a
    two-slot store over V = 600 at headroom 0.5 (root bmax ~900 > V);
    with the state count every member has."""
    if not stacked:
        V = 1024
        tm = TransitionMatrix.from_sids(rng.integers(0, V, (20_000, 3)), V,
                                        dense_d=0, device="cuda")
        return V, tm, DecodePolicy.static, tm.n_states
    V = 600
    reg = ConstraintRegistry(V, dense_d=0, headroom=0.5)
    reg.register("fresh", freshness_window(45))
    reg.register("cats", category_allowlist(0, 1, 2))
    store = reg.build(_catalog(rng, 30_000, V, 3))
    return V, store, DecodePolicy.stacked, int(store.member_n_states.min())


def _mixed_rows(rng, n_states, nb, V):
    """Rows on nodes of every level, the root and the sink among them."""
    nodes = rng.integers(1, n_states, nb).astype(np.int32)
    nodes[::3] = 1  # the root row
    nodes[1::7] = 0  # the sink
    x = torch.from_numpy(rng.normal(size=(nb, V)).astype(np.float32) * 4)
    return x.cuda(), torch.from_numpy(nodes).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("stacked", [False, True])
def test_level_free_mask_block_path_equals_plain_on_the_card(rng, stacked):
    _card()
    V, tables, make, n_states = _level_free_tables(rng, stacked)
    bmax = max(tables.level_bmax)
    assert bmax >= 512 and kv.mask_path(bmax) == "block"
    if stacked:
        assert bmax > V  # the headroom envelope
    policy, plain = make(tables), make(tables, impl="plain")
    assert policy.supports_level_free and plain.supports_level_free
    x, nodes = _mixed_rows(rng, n_states, 350, V)
    cids = (torch.from_numpy(rng.integers(0, 2, 350).astype(np.int32)).cuda()
            if stacked else None)
    name = "vntk_stacked_mask" if stacked else "vntk_mask"
    kv.reset_launches()
    got = policy.level_free_step(x, nodes, constraint_ids=cids)
    assert kv.LAUNCHES == {**{k: 0 for k in kv.LAUNCHES}, name: 1}
    want = plain.level_free_step(x, nodes, constraint_ids=cids)
    assert kv.LAUNCHES[name] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # zero log-probs, as the shared step gives them
    zeros = torch.zeros_like(x)
    got = policy.level_free_step(zeros, nodes, constraint_ids=cids,
                                 normalized=True)
    want = plain.level_free_step(zeros, nodes, constraint_ids=cids,
                                 normalized=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("stacked", [False, True])
def test_shared_mask_step_on_the_card_equals_the_per_level_step(rng, stacked):
    _card()
    V, tables, make, _ = _level_free_tables(rng, stacked)
    policy = make(tables)
    B, M = 5, 70
    N = B * M
    cids = (torch.arange(B, dtype=torch.int32, device="cuda") % 2)[:, None] \
        .expand(B, M) if stacked else None
    cflat = None if cids is None else cids.reshape(N).contiguous()
    nodes = torch.ones((B, M), dtype=torch.int32, device="cuda")
    for step in range(3):
        logits = torch.from_numpy(
            rng.normal(size=(B, M, V)).astype(np.float32)).cuda()
        want_lp, want_next = policy.step(logits, nodes, step,
                                         constraint_ids=cids)
        for share_width in (None, 2, N // 2, N):
            lp, nxt, n_uni = policy.shared_mask_step(
                logits.reshape(N, V), nodes.reshape(N), constraint_ids=cflat,
                share_width=share_width)
            assert torch.equal(lp, want_lp.reshape(N, V)), (step, share_width)
            assert torch.equal(nxt, want_next.reshape(N, V))
            assert 1 <= int(n_uni) <= N
        tok = torch.from_numpy(rng.integers(0, 4, (B, M))).cuda()
        order = torch.argsort(want_lp, dim=-1, descending=True, stable=True)
        pick = order.gather(-1, tok[..., None])  # among the 4 best
        nodes = want_next.gather(-1, pick)[..., 0].to(torch.int32)


def _bf16_lm():
    cfg = TransformerConfig(name="gr-tiny-bf16", n_layers=2, d_model=128,
                            n_heads=8, n_kv_heads=2, d_ff=256, vocab_size=640,
                            dtype="bfloat16", tie_embeddings=True)
    return cfg, transformer.init_params(cfg, 3, device="cuda")


@pytest.mark.gpu
def test_paged_decode_step_on_the_card_equals_decode_step(rng):
    _card()
    cfg, params = _bf16_lm()
    slots, M, S, L, ps = 5, 6, 24, 4, 16
    N, Ls, hd = slots * M, L + 1, cfg.resolved_head_dim()
    prompts = torch.from_numpy(rng.integers(0, 96, (slots, S))).cuda()
    toks = torch.from_numpy(rng.integers(0, 96, (L, slots, M))).cuda()
    with torch.inference_mode():
        _, cache = transformer.prefill(params, prompts, cfg, max_len=S + Ls)
        _, hist = transformer.prefill(params, prompts, cfg, max_len=S)
        cache.k = cache.k.repeat_interleave(M, dim=1)
        cache.v = cache.v.repeat_interleave(M, dim=1)
        n_pages = -(-S // ps)
        table = torch.arange(1, 1 + slots * n_pages,
                             device="cuda").reshape(slots, n_pages)
        pools = kvcache.init_page_pool(
            cfg.n_layers, 1 + slots * n_pages, ps, cfg.n_kv_heads, hd,
            dtype=torch.bfloat16, device="cuda")
        for pool, rows in zip(pools, (hist.k, hist.v)):
            kvcache.scatter_pages(pool, rows, table)
        shape = (cfg.n_layers, slots, M, Ls, cfg.n_kv_heads, hd)
        sk = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
        sv = torch.zeros_like(sk)
        for lv in range(1, L):
            want, cache = transformer.decode_step(
                params, cache, toks[lv].reshape(N, 1), cfg)
            got, sk, sv = transformer.paged_decode_step(
                params, *pools, table, sk, sv, toks[lv],
                torch.full((slots,), S + lv - 1, device="cuda"),
                torch.full((slots,), lv - 1, device="cuda"), cfg, hist_len=S)
            assert torch.equal(got, want), lv


@pytest.mark.gpu
def test_continuous_engine_on_the_card_equals_serving_engine(rng):
    """Equal shapes (slots = prefill chunk = batch size): bit for bit, also
    across a hot swap, with one mask launch per step."""
    _card()
    V, L, M, B = 600, 3, 8, 3
    cfg, params = _bf16_lm()
    reg = ConstraintRegistry(V, dense_d=0, headroom=0.5)
    reg.register("fresh", freshness_window(45))
    reg.register("cats", category_allowlist(0, 1, 2))
    reg.build(_catalog(rng, 20_000, V, L))
    retr = GenerativeRetriever(params, cfg, DecodePolicy.stacked(
        reg.current()[0]), L, V, beam_size=M)
    batch = ServingEngine(params, cfg, B, 16, retriever=retr, registry=reg)
    cont = ContinuousServingEngine(retr, registry=reg, slots=B,
                                   prompt_width=8, page_size=4,
                                   prefill_chunk=B, share_width=B * M // 2)
    for version in (1, 2):
        prompts = rng.integers(0, 96, (7, 8))
        prompts[4] = prompts[0]
        out = []
        for eng in (batch, cont):
            q = RequestQueue()
            for i, p in enumerate(prompts):
                q.submit(p, L, i % 2)
            kv.reset_launches()
            steps = eng.metrics.counter("serving_decode_steps_total").total()
            out.append(eng.serve(q))
            steps = eng.metrics.counter(
                "serving_decode_steps_total").total() - steps
        assert kv.LAUNCHES["vntk_stacked_mask"] == steps
        for rid, want in out[0].items():
            got = out[1][rid]
            assert got["store_version"] == version
            assert np.array_equal(got["sids"], want["sids"])
            assert np.array_equal(got["scores"], want["scores"])
        reg.swap(_catalog(rng, 20_000, V, L))
    assert cont.cold_swaps == 0
    assert cont.metrics.counter("serving_recompiles_total").value(
        expected="false") == 0
    cont.alloc.check()


# ---------------------------------------------------------------------------
# tiering, the prefix-shared decode step and the step timer on the card
# ---------------------------------------------------------------------------
def _tiered_inputs(rng, V=64, L=4, n=3000):
    from repro_torch.constraints import TieredTrie

    sids = rng.integers(0, V, (n, L))
    tm = TransitionMatrix.from_sids(sids, V, dense_d=0, device="cuda")
    table = torch.from_numpy(
        rng.normal(size=(L, V, V)).astype(np.float32)).cuda()
    return tm, TieredTrie.from_matrix(tm, hot_steps=2), table


@pytest.mark.gpu
@pytest.mark.parametrize("topk,compressed", [(True, False), (False, False),
                                             (True, True), (False, True)])
def test_tiered_search_on_the_card_exact_hot_slab(rng, topk, compressed):
    """Hot steps through the CUDA kernels on a hot slab of exactly
    ``cold_base`` rows (its own allocation), bit-equal to the untiered
    search; the run ``compute-sanitizer --tool memcheck`` is pointed at."""
    from repro_torch.constraints import tiered_beam_search

    _card()
    tm, tiered, table = _tiered_inputs(rng)
    L, B, M = tm.sid_length, 3, 5

    def fn(carry, last, step):
        return table[step][last.long()], carry

    want, _ = beam_search(fn, None, B, M, L, DecodePolicy.static(
        tm, topk=topk, compressed=compressed))
    pol = tiered.hot_policy(topk=topk, compressed=compressed)
    slab = pol.backends[-1]
    hot = slab.slab.tok_delta if compressed else slab.tm.edges
    assert hot.shape[0] == tiered.cold_base
    assert hot.untyped_storage().nbytes() == hot.numel() * hot.element_size()
    kv.reset_launches()
    got, _ = tiered_beam_search(fn, None, B, M, L, tiered, policy=pol)
    name = (f"vntk{'_compressed' if compressed else ''}_"
            f"{'topk' if topk else 'mask'}")
    assert kv.LAUNCHES[name] == tiered.hot_steps - tm.dense_d
    assert sum(kv.LAUNCHES.values()) == kv.LAUNCHES[name]
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.scores, want.scores)
    # edges past cold_base that a kernel must never use: poison them
    if not compressed:
        pad = 64
        buf = torch.full((tiered.cold_base + pad, 2), 7, dtype=torch.int32,
                         device="cuda")
        buf[:tiered.cold_base] = slab.tm.edges
        import dataclasses

        poisoned = DecodePolicy.static(dataclasses.replace(
            tiered.tm, edges=buf[:tiered.cold_base]), fused=False, topk=topk)
        again, _ = tiered_beam_search(fn, None, B, M, L, tiered,
                                      policy=poisoned)
        assert torch.equal(again.tokens, want.tokens)
        assert torch.equal(again.scores, want.scores)


@pytest.mark.gpu
def test_prefetcher_stages_through_pinned_memory(rng):
    from repro_torch.constraints import TriePrefetcher

    _card()
    tm, tiered, _ = _tiered_inputs(rng)
    lo, hi = (int(tiered.blocks.state_offsets[2]),
              int(tiered.blocks.state_offsets[3]))
    nodes = torch.from_numpy(
        rng.integers(lo, hi, (3, 5)).astype(np.int32)).cuda()
    want = tiered.gather_cold(nodes.cpu().numpy(), 2)
    with TriePrefetcher(tiered) as pf:
        g, lens = pf.prefetch(nodes, 2).result(timeout=30.0)
        assert g.is_cuda and lens.is_cuda
        assert torch.equal(g.cpu(), torch.from_numpy(want[0]))
        assert torch.equal(lens.cpu(), torch.from_numpy(want[1]))
        (record,) = pf.timings
        assert record["pinned"] and record["pinned_bytes"] == (
            want[0].nbytes + want[1].nbytes)


@pytest.mark.gpu
def test_gr_decode_step_bf16_on_the_card_against_float32_on_the_cpu(rng):
    """bf16 weights and caches on the card against the same values in
    float32 on the CPU: logits within 3e-2 of the logits' largest
    magnitude (bf16 rounds every activation to 8 bits of mantissa)."""
    import dataclasses

    _card()
    cfg, params = _bf16_lm()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_to(params, "cpu", torch.float32)
    B, M, S_h, S_sid, step = 2, 4, 16, 4, 2
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    hk, hv = f(cfg.n_layers, B, S_h, KV, hd), f(cfg.n_layers, B, S_h, KV, hd)
    bk = f(cfg.n_layers, B * M, S_sid, KV, hd)
    bv = f(cfg.n_layers, B * M, S_sid, KV, hd)
    toks = torch.from_numpy(rng.integers(0, 96, (B * M, 1)).astype(np.int32))
    with torch.inference_mode():
        got, gk, _ = transformer.gr_decode_step(
            params, hk.cuda(), hv.cuda(), bk.cuda(), bv.cuda(), toks.cuda(),
            step, cfg)
        want, wk, _ = transformer.gr_decode_step(
            params32, hk.float(), hv.float(), bk.float(), bv.float(), toks,
            step, cfg32)
    err = float((got.cpu() - want).abs().max())
    scale = float(want.abs().max())
    print(f"gr_decode_step bf16 vs float32: largest logit difference "
          f"{err:.3g} of {scale:.3g}")
    assert err <= 3e-2 * scale
    assert torch.isfinite(got).all()


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


@pytest.mark.gpu
def test_step_timer_synchronizes_the_card():
    from repro_torch.observability import MetricsRegistry, StepTimer

    _card()
    reg = MetricsRegistry()
    a = torch.randn(2048, 2048, device="cuda")
    stats = StepTimer("mm", reg, warmup=1, trials=4).measure(
        lambda: a @ a)
    assert stats.trials == 4 and stats.steady_compiles == 0
    assert (stats.dispatch_s <= stats.wall_s).all()
    assert reg.histogram("step_wall_seconds").count(step="mm") == 4


class _GuardedSlab:
    """A device buffer that ends exactly at the end of a mapped granule,
    with the next granule of its address range left unmapped, so a read
    one byte past it faults (the CUDA driver's virtual memory API).  It
    stands in for ``compute-sanitizer --tool memcheck``, which does not
    run on every machine."""

    def __init__(self, src: torch.Tensor):
        import ctypes

        cu = ctypes.CDLL("libcuda.so.1")
        u64, size_t = ctypes.c_uint64, ctypes.c_size_t

        class Location(ctypes.Structure):
            _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]

        class AllocFlags(ctypes.Structure):
            _fields_ = [("compressionType", ctypes.c_ubyte),
                        ("gpuDirectRDMACapable", ctypes.c_ubyte),
                        ("usage", ctypes.c_ushort),
                        ("reserved", ctypes.c_ubyte * 4)]

        class Prop(ctypes.Structure):
            _fields_ = [("type", ctypes.c_int),
                        ("requestedHandleTypes", ctypes.c_int),
                        ("location", Location),
                        ("win32HandleMetaData", ctypes.c_void_p),
                        ("allocFlags", AllocFlags)]

        class Access(ctypes.Structure):
            _fields_ = [("location", Location), ("flags", ctypes.c_int)]

        def check(err, what):
            if err:
                raise RuntimeError(f"{what}: CUresult {err}")

        dev = torch.cuda.current_device()
        prop = Prop(type=1, requestedHandleTypes=0,  # pinned, no handle
                    location=Location(type=1, id=dev))  # device memory
        gran = size_t()
        check(cu.cuMemGetAllocationGranularity(ctypes.byref(gran),
                                               ctypes.byref(prop), 0),
              "cuMemGetAllocationGranularity")
        nbytes = src.numel() * src.element_size()
        self.span = -(-nbytes // gran.value) * gran.value
        self.handle, self.base = u64(), u64()
        check(cu.cuMemCreate(ctypes.byref(self.handle), size_t(self.span),
                             ctypes.byref(prop), u64(0)), "cuMemCreate")
        check(cu.cuMemAddressReserve(ctypes.byref(self.base),
                                     size_t(2 * self.span), size_t(0),
                                     u64(0), u64(0)), "cuMemAddressReserve")
        check(cu.cuMemMap(self.base, size_t(self.span), size_t(0),
                          self.handle, u64(0)), "cuMemMap")
        access = Access(location=Location(type=1, id=dev), flags=3)
        check(cu.cuMemSetAccess(self.base, size_t(self.span),
                                ctypes.byref(access), size_t(1)),
              "cuMemSetAccess")
        self.cu = cu
        ptr = self.base.value + self.span - nbytes  # ends at the gap
        typestr = {torch.int32: "<i4", torch.int16: "<i2"}[src.dtype]
        self.__cuda_array_interface__ = dict(
            shape=tuple(src.shape), typestr=typestr, data=(ptr, False),
            version=3, strides=None)
        self.tensor = torch.as_tensor(self, device="cuda")
        self.tensor.copy_(src)
        torch.cuda.synchronize()

    def close(self):
        import ctypes

        torch.cuda.synchronize()
        self.cu.cuMemUnmap(self.base, ctypes.c_size_t(self.span))
        self.cu.cuMemRelease(self.handle)
        self.cu.cuMemAddressFree(self.base, ctypes.c_size_t(2 * self.span))


@pytest.mark.gpu
@pytest.mark.parametrize("topk,compressed", [(True, False), (False, False),
                                             (True, True), (False, True)])
def test_tiered_hot_slab_ends_at_a_guard_gap(rng, topk, compressed):
    """The hot slab (or the slab's ``tok_delta`` prefix) placed so that its
    last byte is the last byte of mapped memory: the kernels' hot steps,
    which must read nothing past ``cold_base``, run without a fault and
    give the untiered search's bits."""
    import dataclasses

    from repro_torch.constraints import tiered_beam_search

    _card()
    tm, tiered, table = _tiered_inputs(rng)
    L, B, M = tm.sid_length, 3, 5

    def fn(carry, last, step):
        return table[step][last.long()], carry

    want, _ = beam_search(fn, None, B, M, L, DecodePolicy.static(
        tm, topk=topk, compressed=compressed))
    pol = tiered.hot_policy(topk=topk, compressed=compressed)
    sparse = pol.backends[-1]
    src = sparse.slab.tok_delta if compressed else sparse.tm.edges
    guard = _GuardedSlab(src)
    try:
        if compressed:
            moved = dataclasses.replace(sparse, slab=dataclasses.replace(
                sparse.slab, tok_delta=guard.tensor))
        else:
            moved = dataclasses.replace(sparse, tm=dataclasses.replace(
                sparse.tm, edges=guard.tensor))
        pol = dataclasses.replace(pol, backends=pol.backends[:-1] + (moved,))
        kv.reset_launches()
        got, _ = tiered_beam_search(fn, None, B, M, L, tiered, policy=pol)
        torch.cuda.synchronize()  # a read past the slab faults here
        assert sum(kv.LAUNCHES.values()) == tiered.hot_steps - tm.dense_d
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.scores, want.scores)
    finally:
        guard.close()


_PAST_THE_END = """
import sys
import torch
from test_torch_gpu import _GuardedSlab

src = torch.arange(1000, dtype=torch.int32, device="cuda").reshape(500, 2)
guard = _GuardedSlab(src)
assert torch.equal(guard.tensor, src)
ptr = guard.__cuda_array_interface__["data"][0]


class PastTheEnd:
    __cuda_array_interface__ = dict(shape=(1001,), typestr="<i4",
                                    data=(ptr, False), version=3,
                                    strides=None)


print(int(torch.as_tensor(PastTheEnd(), device="cuda").sum()))
torch.cuda.synchronize()
print("NO FAULT")
"""


@pytest.mark.gpu
def test_guard_gap_faults_on_a_read_past_the_slab():
    """The guard gap's positive control, in a child process (the fault is
    sticky): a read one int32 past a guarded slab must fault."""
    import os
    import subprocess
    import sys

    _card()
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here, src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _PAST_THE_END], env=env,
                         capture_output=True, text=True, timeout=120)
    assert "NO FAULT" not in out.stdout
    assert out.returncode != 0
    assert "illegal memory access" in out.stderr, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# training on the card: the bag's gradient, the bf16 attention backward, a
# Trainer step
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,mode", [(torch.float32, "sum"),
                                        (torch.float32, "mean"),
                                        (torch.bfloat16, "sum")])
def test_bag_gradient_on_the_card_matches_the_plain_route(rng, dtype, mode):
    """The kernel route's ``autograd.Function`` vs torch's autograd through
    the plain version, for one table and for a group of three (ids out of
    range included: the clamped rows get their gradient).  Every table's
    ``.grad`` must be set.  float32: equal, both scatters run under
    ``torch.use_deterministic_algorithms``.  bfloat16: the kernel route
    accumulates in float32 where the plain route adds in bfloat16, so the
    kernel route is held against a float64 sum on the host instead, within
    one bfloat16 ulp (rtol 2^-7) of its rounding."""
    _card()
    B, K, D = 300, 3, 16
    tables = [_inputs(rng, B, K, D, dtype, R=R)[0] for R in (50, 200, 7)]
    ids = torch.from_numpy(np.stack(
        [rng.integers(-3, R + 6, (B, K)) for R in (50, 200, 7)],
        axis=1).astype(np.int32)).cuda()
    cot = torch.randn(B, 3, D, device="cuda").to(dtype)
    grads = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for impl in (None, "plain"):
            ts = [t.clone().requires_grad_(True) for t in tables]
            n = bag.LAUNCHES["embedding_bag"]
            out = ops.embedding_bag_grouped(ts, ids, mode, impl=impl)
            single = ops.embedding_bag(ts[1], ids[:, 1], mode, impl=impl)
            assert out.requires_grad and single.requires_grad
            assert bag.LAUNCHES["embedding_bag"] - n == (2 if impl is None
                                                         else 0)
            ((out.float() * cot.float()).sum()
             + (single.float() * cot[:, 1].float()).sum()).backward()
            assert all(t.grad is not None for t in ts)
            grads[impl] = [t.grad for t in ts]
    finally:
        torch.use_deterministic_algorithms(was)
    ids64 = ids.cpu().long()
    for f, (got, want) in enumerate(zip(grads[None], grads["plain"])):
        assert got.dtype == dtype
        if dtype == torch.float32:
            assert torch.equal(got, want)
            continue
        g = cot[:, f].double().cpu() / (K if mode == "mean" else 1)
        if f == 1:  # the single-table call adds its own cotangent
            g = g * 2
        exact = torch.zeros(tables[f].shape, dtype=torch.float64)
        exact.index_add_(0, ids64[:, f].clamp(0, tables[f].shape[0] - 1)
                         .reshape(-1), g[:, None].expand(B, K, D).reshape(
                             B * K, D))
        torch.testing.assert_close(got.cpu().double(), exact.to(dtype).double(),
                                   rtol=2 ** -7, atol=1e-30)


@pytest.mark.gpu
def test_recsys_tables_never_come_back_detached_on_the_card(rng):
    """recsys_loss through the kernel route: every table and wide table of
    FM's smoke config gets a gradient, and the loss equals impl='plain'."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import recsys

    _card()
    cfg = smoke_config("fm")
    params = recsys.init_params(cfg, seed=0, device="cuda")
    sparse = np.stack([rng.integers(0, v + 2, (64, 1))
                       for v in cfg.vocab_sizes], axis=1).astype(np.int32)
    batch = {"sparse": torch.from_numpy(sparse).cuda(),
             "label": torch.from_numpy(rng.integers(0, 2, 64).astype(
                 np.float32)).cuda()}
    for p in params.values():
        p.requires_grad_(True)
    loss = recsys.recsys_loss(params, batch, cfg)
    loss.backward()
    for k, p in params.items():
        assert p.grad is not None, k
    assert float(p.grad.abs().sum()) > 0
    with torch.no_grad():
        plain = recsys.recsys_loss(params, batch, cfg, impl="plain")
    assert torch.equal(loss.detach(), plain)


@pytest.mark.gpu
def test_lm_loss_backward_in_bf16_on_the_card():
    """static-gr's smoke config in bfloat16 on the card: the attention's
    float32-output products run under their ``autograd.Function``; the
    loss within 2e-2 and each gradient within a relative L2 error of 5e-2
    of a float32 recompute from the same (bf16-valued) weights."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.training.tree import flatten_with_path, tree_map

    _card()
    cfg = dataclasses.replace(smoke_config("static-gr"), dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p16 = transformer.init_params(cfg, seed=0, device="cuda")
    p32 = tree_map(lambda t: t.float(), p16)
    tok = torch.randint(0, cfg.vocab_size, (4, 32), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    out = {}
    for name, p, c in (("bf16", p16, cfg), ("f32", p32, cfg32)):
        leaves = [l.requires_grad_(True) for _, l in flatten_with_path(p)]
        loss = transformer.lm_loss(p, tok, c)
        out[name] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    torch.testing.assert_close(out["bf16"][0], out["f32"][0], rtol=2e-2,
                               atol=0)
    for g16, g32 in zip(out["bf16"][1], out["f32"][1]):
        assert g16.dtype == torch.bfloat16
        err = (g16.float() - g32).norm() / g32.norm().clamp_min(1e-12)
        assert float(err) < 5e-2


@pytest.mark.gpu
def test_one_trainer_step_on_the_card():
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import build, synth_batches
    from repro_torch.training import Trainer, TrainerConfig, adamw

    _card()
    cfg, params, loss_fn = build("static-gr", "cuda")
    before = params["emb"].clone()
    t = Trainer(loss_fn, adamw(lr=1e-3), params,
                TrainerConfig(n_steps=1, microbatches=2))
    losses = t.fit(synth_batches("static-gr", cfg, 4), log=lambda *a: None)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert t.params["emb"].is_cuda
    assert not torch.equal(t.params["emb"], before)
    assert t.opt_state["m"]["emb"].dtype == torch.float32
    assert smoke_config("static-gr").n_layers == len(t.params["layers"])


def _smoke_inputs(cfg, shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_moe_ffn_on_the_card_matches_the_cpu(arch):
    """The smoke MoE (float32, TF32 off) on the card against the same call
    on the CPU: expert ids, positions and ``keep`` equal; outputs within
    1e-5 of their largest magnitude (cuBLAS sums in another order), the
    aux loss within 1e-6."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe

    _card()
    cfg = smoke_config(arch)
    m, D = cfg.moe, cfg.d_model
    params = moe.moe_init(torch.Generator().manual_seed(0), D, m,
                          torch.float32, "cpu")
    x = _smoke_inputs(cfg, (2, 16, D))
    want, aux_want = moe.moe_ffn(params, x, m)
    on_card = _tree_to(params, "cuda", torch.float32)
    got, aux = moe.moe_ffn(on_card, x.cuda(), m)
    for a, b in zip(moe.route(params["router"], x.reshape(1, -1, D), m)[2:],
                    moe.route(on_card["router"], x.cuda().reshape(1, -1, D),
                              m)[2:]):
        assert torch.equal(a, b.cpu())
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale
    assert abs(float(aux) - float(aux_want)) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_gnn_forward_on_the_card_matches_the_cpu(aggregator):
    """MeshGraphNet's smoke config (float32) on the card against the CPU,
    one graph and three batched: within 1e-5 of the largest output (the
    card's ``index_add_`` adds a node's messages in the order its atomics
    land)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import gnn

    _card()
    cfg = dataclasses.replace(smoke_config("meshgraphnet"),
                              aggregator=aggregator)
    params = gnn.init_params(cfg, seed=0, device="cpu")
    on_card = _tree_to(params, "cuda", torch.float32)
    rng = np.random.default_rng(0)
    for lead in ((), (3,)):
        N, E = 40, 120
        args = (_smoke_inputs(cfg, lead + (N, cfg.node_feat_dim)),
                _smoke_inputs(cfg, lead + (E, cfg.edge_feat_dim), seed=1),
                torch.from_numpy(rng.integers(0, N, lead + (E,))),
                torch.from_numpy(rng.integers(0, N, lead + (E,))))
        want = gnn.forward(params, *args, cfg)
        got = gnn.forward(on_card, *(a.cuda() for a in args), cfg)
        assert got.shape == want.shape
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_moe_decode_step_is_deterministic_on_the_card(arch):
    """A bf16 MoE decode step (mixtral on its ring, deepseek's absorbed MLA)
    run twice from equal caches gives bit-equal logits: the dispatch
    scatters to unique rows and the combine sums in a fixed order."""
    import dataclasses

    from repro_torch.configs import smoke_config

    _card()
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (8, 13), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    _, cache = transformer.prefill(params, tok[:, :12], cfg, max_len=16)
    names = ("c_kv", "k_rope") if cfg.attention == "mla" else ("k", "v")
    logits = [transformer.decode_step(
        params, dataclasses.replace(cache, **{n: getattr(cache, n).clone()
                                              for n in names}),
        tok[:, 12:], cfg)[0] for _ in range(2)]
    assert torch.isfinite(logits[0]).all()
    assert torch.equal(logits[0], logits[1])


@pytest.mark.gpu
def test_spmd_retriever_in_a_world_of_one_on_the_card(rng):
    """A world of one over nccl, mesh (1, 1): ``SpmdRetriever`` on a
    stacked store equals ``GenerativeRetriever`` bit for bit, through the
    stacked topk kernel, and the world is gone after."""
    _card()
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh, world
    from repro_torch.serving.spmd_engine import SpmdRetriever

    V, L = 32, 4
    cfg = TransformerConfig(name="gr-tiny", n_layers=2, d_model=32,
                            n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=34,
                            dtype="float32", tie_embeddings=True)
    params = transformer.init_params(cfg, 0, device="cuda")
    store = _registry(V, headroom=0.5).build(_catalog(rng, 120, V, L))
    hist = rng.integers(0, 34, (3, 8))
    cids = np.array([0, 1, 1], np.int32)
    with world("cuda"):
        assert dist.get_backend() == "nccl"
        r = SpmdRetriever(params, cfg, store, L, V, beam_size=4,
                          mesh=make_debug_mesh(model=2))
        kv.reset_launches()
        got = r.retrieve(hist, cids)
        assert kv.LAUNCHES["vntk_stacked_topk"] == L - store.dense_d
        assert sum(kv.LAUNCHES.values()) == L - store.dense_d
    assert not dist.is_initialized()
    want = GenerativeRetriever(params, cfg, store, L, V,
                               beam_size=4).retrieve(hist, cids)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the decode-attention kernel
# ---------------------------------------------------------------------------
# (max, mean) abs difference from the plain version on the card.  bf16: the
# kernel adds the float32 scores and the PV products in another order than
# cuBLAS, so a probability near a bf16 rounding boundary can round the other
# way before the PV product, and the output's own bf16 rounding can then
# flip (one ulp of outputs below 4); fp16 rounds both at 11 bits instead of
# 8; float32 differs by the summation order alone.
ATTN_TOL = {torch.bfloat16: (2.0 ** -6, 1e-4), torch.float16: (2.0 ** -9, 1e-5),
            torch.float32: (1e-5, 1e-6)}


def _attn(rng, B, S, KVH, G, Dh, Dv=None, dtype=torch.bfloat16):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype).cuda()
    return (t(B, 1, KVH * G, Dh), t(B, S, KVH, Dh), t(B, S, KVH, Dv or Dh))


def _against_plain(q, k, v, pos, cur, window=None):
    before = da.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, pos, cur, window=window)
    assert da.LAUNCHES["decode_attention"] == before + 1
    want = ops.decode_attention(q, k, v, pos, cur, window=window,
                                impl="plain")
    assert got.dtype == want.dtype and got.shape == want.shape
    d = (got.float() - want.float()).abs()
    tol_max, tol_mean = ATTN_TOL[k.dtype]
    assert float(d.max()) <= tol_max and float(d.mean()) < tol_mean, (
        float(d.max()), float(d.mean()))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [140, 560])
def test_decode_attention_kernel_at_the_cells_shapes(rng, rows):
    """static-gr-3b's decode at B = 2 and B = 8: 265 slots, the last one
    empty, 8 KV heads, G = 3, Dh = 128, bf16."""
    _card()
    S = 265
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    pos[-1] = -1
    _against_plain(*_attn(rng, rows, S, 8, 3, 128), pos, S - 2)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 257, 1100, 2500])
def test_decode_attention_kernel_short_and_split_routes(rng, S):
    """A one-slot cache, an odd length past a tile, and caches past
    ``SHORT_MAX_S`` that take the split route (2 and 3 splits)."""
    _card()
    assert da.route(S) == ("split" if S > da.SHORT_MAX_S else "short")
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    _against_plain(*_attn(rng, 3, S, 2, 3, 128), pos, S - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["empty_slots", "window", "float16",
                                  "float32", "g1_dh64", "g8_dh64", "dv_wider",
                                  "split_window"])
def test_decode_attention_kernel_masks_dtypes_and_heads(rng, case):
    """(B, S) slot positions with empty slots and a row with none live
    (uniform weights) under a (B,) position tensor, as the continuous engine
    passes; a window over a ring cache; fp16 and float32 caches; Dh = 64
    with G = 1 and G = 8; Dv > Dh; a window on the split route."""
    _card()
    B, S, KVH, G, Dh, Dv, dtype, window = 4, 96, 2, 3, 128, None, \
        torch.bfloat16, None
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    cur = S - 1
    if case == "empty_slots":
        pos = pos.repeat(B, 1)
        pos[:, 80:] = -1
        pos[1, ::3] = -1
        cur = torch.tensor([79, 40, -3, 60], device="cuda")
    elif case == "window":
        W = 64  # a ring past its window: slot i holds position 200 - W + ...
        pos = (200 - W + torch.randperm(W, generator=torch.Generator().manual_seed(
            0))).to(torch.int32).cuda()
        S, cur, window = W, 199, 40
    elif case in ("float16", "float32"):
        dtype = getattr(torch, case)
    elif case == "g1_dh64":
        KVH, G, Dh = 8, 1, 64
    elif case == "g8_dh64":
        KVH, G, Dh = 2, 8, 64
    elif case == "dv_wider":
        Dh, Dv = 64, 128
    elif case == "split_window":
        S, window = 1500, 1200
        pos = torch.arange(S, dtype=torch.int32, device="cuda")
        cur = S - 1
    _against_plain(*_attn(rng, B, S, KVH, G, Dh, Dv, dtype), pos, cur,
                   window)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [265, 1100])
def test_decode_attention_row_alone_equals_the_row_among_many(rng, S):
    """No route, split or order depends on the number of rows: a row
    computed alone is bit-equal to the same row among 560."""
    _card()
    q, k, v = _attn(rng, 560, S, 8, 3, 128)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    cur = torch.full((560,), S - 1, device="cuda")
    cur[::7] = S // 2
    many = ops.decode_attention(q, k, v, pos, cur)
    for r in (0, 7, 333, 559):
        alone = ops.decode_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1], pos,
                                     cur[r:r + 1])
        assert torch.equal(alone, many[r:r + 1]), r


@pytest.mark.gpu
def test_decode_attention_launches_once_a_call_and_per_retrieve(rng):
    """One launch a call on either route; a retrieve's decode steps launch
    it ``n_layers * (L - 1)`` times, and no call reaches the plain version."""
    _card()
    for S in (265, 1100):
        q, k, v = _attn(rng, 2, S, 2, 3, 64)
        pos = torch.arange(S, dtype=torch.int32, device="cuda")
        da.reset_launches()
        ops.decode_attention(q, k, v, pos, S - 1)
        assert da.LAUNCHES["decode_attention"] == 1
    cfg, params = _bf16_lm()
    L, V, M, B = 4, 600, 6, 2
    retr = GenerativeRetriever(params, cfg, DecodePolicy.unconstrained(), L, V,
                               beam_size=M)
    hist = rng.integers(0, 96, (B, 12))
    plain = da.decode_attention_plain
    try:
        da.decode_attention_plain = None  # any plain call fails
        da.reset_launches()
        retr.retrieve(hist)
        assert da.LAUNCHES["decode_attention"] == cfg.n_layers * (L - 1)
    finally:
        da.decode_attention_plain = plain
