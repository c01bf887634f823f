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
the card with no VNTK launch.
"""
import numpy as np
import pytest
import torch

from repro_torch.constraints import ConstraintStore
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
