#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--constraints N] [--layers N] [--batches N] [--profile]

Phases (any failure raises and the script exits non-zero):

1. build    — compile ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a (one
              ``nvcc`` per source, all at once) and print the build time and
              ptxas resource lines.
2. indexes  — a catalog of ``--constraints`` items (default 20M) with SIDs
              uniform over V=2048, L=8, ``age_days`` uniform over [0, 90) and
              ``category`` uniform over 8 (the reference's
              ``synthetic_catalog``).  The trie of every SID serves the
              single-matrix path; the ``multi_constraint`` scenario's five
              slots (``freshness_window(22.5/45/67.5/90)``,
              ``category_allowlist(0, 1)``) are stacked into a
              ``ConstraintStore`` at dense_d=2 and headroom 0.5 by
              ``ConstraintRegistry.build`` (the slots' tries built on the
              host in a thread pool, the store on the card), whose build
              time is printed.  The
              delta-compressed edge slab of each (DESIGN.md §11) is built on
              the card; its dtype must be int16 and its bytes (row pointers,
              deltas, level bases) at most 0.7x the uncompressed CSR's (the
              reference's gate, ``benchmarks/memory_table.py``).
3. kernels  — every CUDA kernel function against its plain PyTorch version
              on the card.  Single-matrix functions at the single path's
              shapes (nb = 2*70 rows, V = 2048, C = 72, each sparse level's
              bmax and trie nodes) and stress shapes (prime nb, a bmax >= 512
              root row of a dense_d=0 trie, rows at the sink, tie-heavy
              logits).  Stacked functions at the stacked path's shapes (nb =
              5*70 rows, one request per slot, each row on its own member's
              level), at stress shapes (prime nb, rows at the sink, ids out
              of range that the kernels clamp, ties) and at an offset stress:
              a store of ten copies of the 20M trie (~14.7 GB, freed after)
              whose last member's deepest edges lie past 2^31 int32 elements
              from the store's base, where tokens and next states must equal
              the single-matrix kernel's.  The compressed-slab functions run
              the same shapes over the slabs, an int32 slab (V > 32768, a
              root row of ~40k slots for the mask kernels, cut to 4096 for
              the topk ones, and level 1) besides, and must also equal their
              uncompressed twin kernels on the same rows.  The topk kernel
              takes a warp per row for bmax <= 32 and a block per row above;
              each topk function must be checked on both routes: the warp
              route also at bmax = 32 exactly (a root row cut to 32 slots;
              stacked, the stress rows), and at V = width = 64 with valid
              log-probs at NEG_INF, -inf and (not fused) -FLT_MAX, where
              -FLT_MAX candidates must reach the output, and (fused) on
              logit rows off 16-byte alignment; the block route at the root
              rows and, stacked, the stress rows at bmax 64.  The mask
              kernel is a block per row whose warp 0 holds the slots for
              bmax <= 32 (the "warp" path) and whose block scatters them
              above (the "block" path); each mask function must be checked
              on both: root rows cut to bmax 32 and 33, level-1 rows of
              small tries at V = 64 and V = 62 (V % 4 != 0: scalar loads
              and scalar fill) cut to 32 and 33 with valid values at
              NEG_INF, -inf and (not fused) -FLT_MAX, and (fused) logit
              rows off 16-byte alignment.
              Tokens and next states must be equal; scores equal when not
              fused, within rtol/atol 1e-5 when fused.  Device times come
              from CUDA graphs of back-to-back calls timed by CUDA events;
              the latency floor of each kernel (nb = 1, bmax = 1, not
              fused; topk width 8) is printed.
              The golden traces of ``tests/golden`` (``stacked`` included)
              are replayed through the kernels, with and without the
              compressed slab, and the §5.2 baselines' (``ppv_exact``,
              ``cpu_trie``, ``hash_bitmap``) with their tables on the card;
              the bf16 attention products on the card are held against the
              CPU's.
4. single   — ``static_gr.CONFIG`` (26 layers, d_model 3072, GQA 24/8, bf16)
              with seeded random weights serving B=2 requests of 256-token
              histories at M=70, L=8 through ``GenerativeRetriever.retrieve``
              under eight single-matrix policies (topk / topk fused /
              vocab-aligned / vocab-aligned fused, each without and with
              ``compressed=True``, each run right after its twin).  Every
              live beam must be in the constraint set, each policy's kernel
              must launch exactly L - dense_d = 6 times per retrieve and no
              other kernel (the launch counters are zeroed just before this
              phase and read just after), each compressed policy must give
              the SIDs and scores of its uncompressed twin bit for bit, and
              one batch rerun with the plain constraint step
              (``impl="plain"``) must give equal SIDs and scores.
5. stacked  — the same model serving B=5 requests, request i under slot i
              (``constraint_ids = [0..4]``), through the eight stacked
              policies.  Every live beam of row i must be in slot i's SID
              set; each policy's kernel must launch exactly 6 times per
              retrieve and no other kernel (counters zeroed just before,
              read just after); each compressed policy must equal its
              uncompressed twin bit for bit.  Row 0 must equal, bit for bit,
              the single-matrix retrieve over ``store.member(0)`` of the same
              batch; a plain rerun must give equal SIDs and scores; a hot
              swap of a re-aged ``fresh_22`` under the default and the
              compressed policy must be reported hot and keep row 0
              compliant with the new set.
6. engine   — phase 5's retrievers released, ``ServingEngine`` over the
              phase-2 registry (B = 5, max_len 512, the stacked policy, M =
              70).  (a) 20 requests of 256-token histories in a skewed burst
              over lanes 0-4 (8, 4, 4, 2, 2): the first batch holds all five
              lanes and must equal, bit for bit, a direct ``retrieve`` of the
              same histories and ids; every batch must launch the stacked
              topk kernel L - dense_d = 6 times and no other VNTK kernel
              (the counters are zeroed just before each serve and read just
              after), and every live beam must be in its row's
              ``slot_sids``.  (b) 1% churn (the ``refresh_churn``
              scenario's): a ``CatalogDelta`` removing 200,000 catalog SIDs
              and adding 200,000 seeded items, submitted through
              ``AsyncRefresher.apply_delta_async`` while the engine serves
              rounds of 5 requests (at least 4, until the future resolves,
              then 3 more): the future must give version 2, the engine must
              count 1 hot swap, no cold one and no unexpected
              specialization, drop no request, and every row must comply
              with the slot sets of the version in its ``store_version``.
              It prints the worker's seconds (trie assembly, upload and
              stack, flip), the largest staleness, batch latencies before,
              during and after the refresh, and the peak device memory
              during the swap.  (c) A second registry of 100,000 seeded
              items at headroom 0 and ``swap_async`` of a 300,000-item
              snapshot: one cold swap, exactly 1 specialization on the next
              batch and 0 on the one after, compliance under the regrown
              store.  (d) ``ServingEngine.generate``, greedy, B = 2, 4
              tokens, equal to a manual ``prefill``/``decode_step`` loop.
              One ``{"engine": ...}`` JSON line carries the numbers; the
              engine's stacked topk launches join that kernel's row.
7. table1   — the paper's Table 1 baselines (§5.2) beside STATIC, while
              the catalog trie, the store and the model are on the card:
              DISC-PPV's sorted table of the whole catalog (exact, and
              approximate over the top 50), the hash bitmap of every prefix
              (2^27 bits, built on the card), the CPU trie over a seeded
              200,000-SID subset (a nested-dict trie of the 20M catalog does
              not fit the run; the reference's Table 1 cuts it the same way,
              ``benchmarks/table1_latency.py:133``) beside STATIC over a trie
              of the same subset, and the unconstrained step.  (a) Per step,
              as in Table 1: nb = 140 rows (B = 2 x M = 70), seeded logits,
              nodes and prefixes walked down catalog SIDs; each policy's
              Phase 1-2 call (``static``, ``static_fused``, ``static_dense``,
              ``stacked`` with every row on ``fresh_90``, whose set is the
              whole catalog, the baselines, ``unconstrained``, and
              ``static`` through ``step_topk`` at its sparse levels) timed at
              each level in CUDA graphs between CUDA events, and also eager
              (host dispatch included); the CPU trie by a host clock around
              a synchronized call.  Overhead per level is the median minus
              the median of the log-softmax alone (clamped at 0, the
              Appendix C rule); the mean over the 8 levels and the worst
              level are reported.  At every level ``ppv_exact``'s and
              ``stacked``'s valid sets must equal ``static``'s, the CPU
              trie's STATIC's over the same subset, ``ppv_approx``'s lie
              within ``ppv_exact``'s, the bitmap's contain ``static``'s, and
              ``unconstrained`` must return the log-softmax unchanged.  (b)
              static-gr-3b on phase 4's batches under ``ppv_exact``,
              ``ppv_approx``, ``hash_bitmap``, ``unconstrained`` and
              ``cpu_trie``, in turns with ``static`` batch by batch: PPV
              exact and the CPU trie must give SIDs and
              scores bit-equal to their STATIC twins' (phase 4's over the
              catalog; over the subset for the CPU trie), topk and
              vocab-aligned plans alike; every live beam of PPV approximate
              must be in the catalog; the bitmap's compliance share and
              false-positive rate are printed; no VNTK kernel may launch
              (the counters are zeroed just before and read just after).
              One ``{"table1": ...}`` JSON line carries the overheads (ms),
              the ratios of ``cpu_trie``, ``ppv_exact``, ``ppv_approx`` and
              ``hash_bitmap`` to ``static``, and each median retrieve ms.
8. bag      — the retrieval phases' tensors released, the EmbeddingBag
              kernel (``csrc/embedding_bag.cu``) against its plain version
              on the card.  Single-table entry: the reference's sweep ((B,
              K, D) in (8, 1, 32), (16, 4, 128), (5, 7, 64); float32 and
              bfloat16; sum and mean; R = 200), ids out of range (negative
              and past R, which the kernel clamps) with K = 7 means, and the
              recsys path's per-table shapes (K = 1; D = 32 and 1 on a
              10M-row table, D = 10 on a 1M-row one; B = 512 and 262,144).
              Grouped entry (one launch per 64 tables of one width): F = 70
              (two launches), a bf16 D = 32 group on the 16-byte path, a
              group of views 4 bytes off a 16-byte boundary on the scalar
              path, K = 7 means of clamped ids on both paths, and wide-deep's
              D = 32 and D = 1 and FM's D = 10 and D = 1 table sets on their
              own seeded tables at B = 512 and 262,144.  An int64 stress:
              DLRM-MLPerf's largest table (39,979,776 x 128 float32,
              20.5 GB, freed after) read in its last rows, past 2^31
              elements, alone and as a group's second member beside a small
              table.  K = 1 and grouped sums must be bit-equal; means within
              rtol/atol 1e-6 (float32) or one bf16 ulp; each grouped check
              must take the expected load path (``v16`` or ``scalar``) and
              launch once per 64 tables.  The kernel, the plain version and
              the library yardstick (``F.embedding_bag``; for a group, its
              per-table calls in one CUDA graph; used nowhere in the port)
              are timed at the path's shapes as in phase 3.
9. recsys   — wide-deep at its published size (40 tables of 32 floats and
              40 wide tables, 111,104,000 padded rows, 14.7 GB, seeded on the
              card) through ``recsys.forward`` at the reference's
              ``serve_p99`` (B = 512) and ``serve_bulk`` (B = 262,144)
              shapes, one warm-up and ``--batches`` timed batches each, ids
              uniform over each table: scores finite, bit-equal to the same
              batch with ``impl="plain"``, exactly 2 bag launches per
              forward (one grouped launch for the table_i bags, one for the
              wide_i bags; the launch counters are zeroed just before this
              phase and read just after; no VNTK counter may move).  Then
              FM at its published size (1.15 GB) at ``serve_p99``: 2
              launches per forward, bit-equal to plain; and MIND at its
              published size (10M x 64 items) at ``retrieval_cand`` (1M
              candidates, no bag launch): finite scores.  The phase's peak
              device memory is printed.
10. report  — the card's ``nvidia-smi`` name and power limit, one JSON line
              with a row per kernel function (a VNTK row with the ``path``
              its main-path levels took, ``warp`` or ``block``, for topk
              and mask alike; for the bag,
              one per timed shape, each with its load ``path``; a
              single-table row counts the main path's launches at its
              per-table (B, K, D), all of them grouped), then the last line
              ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Without CUDA, or without the repository's ``src/`` beside it, the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SLOTS = {  # the multi_constraint scenario's slots: (predicate, argument)
    "fresh_22": ("freshness_window", 22.5),
    "fresh_45": ("freshness_window", 45.0),
    "fresh_67": ("freshness_window", 67.5),
    "fresh_90": ("freshness_window", 90.0),
    "cat_01": ("category_allowlist", (0, 1)),
}
HEADROOM = 0.5  # the registry's and the scenario's default
SLAB_GATE = 0.7  # compressed / uncompressed CSR bytes (memory_table.py)


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--constraints", type=int, default=None,
                    help="catalog size (default: static_gr.N_CONSTRAINTS)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the single-matrix path's depth (default: the "
                         "config's 26; the stacked path always runs all 26)")
    ap.add_argument("--batches", type=int, default=3,
                    help="timed request batches per policy (after one warm-up)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one retrieve of each path with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args()


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device milliseconds of one ``fn()``: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# ---------------------------------------------------------------------------
# phase 2: the indexes
# ---------------------------------------------------------------------------
def slot_predicates() -> dict:
    """The slots' predicates, by name, from the port's registry module."""
    from repro_torch import constraints

    return {name: (getattr(constraints, kind)(*arg) if isinstance(arg, tuple)
                   else getattr(constraints, kind)(arg))
            for name, (kind, arg) in SLOTS.items()}


def registry(headroom=HEADROOM):
    """A ConstraintRegistry on the card with the five slots registered."""
    from repro_torch.configs import static_gr
    from repro_torch.constraints import ConstraintRegistry

    reg = ConstraintRegistry(static_gr.SID_VOCAB, dense_d=static_gr.DENSE_D,
                             headroom=headroom, device="cuda")
    for name, pred in slot_predicates().items():
        reg.register(name, pred)
    return reg


def build_indexes(rng, n):
    """The catalog's single trie, and the registry whose store stacks the
    five slots.

    Catalog items are kept in SID order, so every slot's SID set is a sorted
    subset and trie construction skips its sort.
    """
    from repro_torch.configs import static_gr
    from repro_torch.constraints import ItemCatalog
    from repro_torch.constraints.registry import BUILD_THREADS
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.trie import (
        build_flat_trie,
        infer_level_blocks,
        sorted_unique_sids,
    )

    V, L, d = static_gr.SID_VOCAB, static_gr.SID_LENGTH, static_gr.DENSE_D
    t0 = time.time()
    sids = sorted_unique_sids(rng.integers(0, V, size=(n, L)))
    ft = build_flat_trie(sids, V, dense_d=d)
    tm = TransitionMatrix.from_flat_trie(ft, device="cuda")
    log(f"  trie of {n} random SIDs: {ft.n_states} states, {ft.n_edges} "
        f"edges, {tm.nbytes() / 1e9:.3f} GB on the card, level bmax "
        f"{list(map(int, ft.level_bmax))} ({time.time() - t0:.1f}s host build)")

    catalog = ItemCatalog(sids=sids, age_days=rng.uniform(0.0, 90.0, len(sids)),
                          category=rng.integers(0, 8, len(sids)))
    t0 = time.time()
    reg = registry()
    store = reg.build(catalog)
    build_s = time.time() - t0
    masks = {name: np.asarray(pred(catalog))
             for name, pred in slot_predicates().items()}
    log(f"  ConstraintRegistry.build of {len(SLOTS)} slots "
        f"({', '.join(f'{k}: {int(m.sum())}' for k, m in masks.items())} SIDs)"
        f" at headroom {HEADROOM}: {store.n_states} states and "
        f"{store.n_edges} edge rows per member, level bmax "
        f"{list(store.level_bmax)}, {store.nbytes() / 1e9:.3f} GB on the "
        f"card in {build_s:.1f}s (tries built on the host in "
        f"{BUILD_THREADS} threads, then uploaded)")
    slot_sids = [np.asfortranarray(sids[m]) for m in masks.values()]
    offsets = []  # each member's first state per level, read on the card
    for k in range(store.num_sets):
        m = store.member(k)
        offsets.append(infer_level_blocks(
            m.row_pointers, m.edges, n_states=m.n_states, n_edges=m.n_edges,
            sid_length=L, dense_d=d).state_offsets)
    slab, store_slab = build_slabs(tm, store)
    return dict(sids=sids, ft=ft, tm=tm, store=store, slot_sids=slot_sids,
                level_offsets=offsets, sorted_sids=np.asfortranarray(sids),
                slab=slab, store_slab=store_slab, registry=reg,
                catalog=catalog, registry_build_s=build_s)


def build_slabs(tm, store):
    """The compressed edge slabs of the trie and of the store, built on the
    card; each must be int16 and at most SLAB_GATE of the CSR bytes."""
    from repro_torch.core import memory_model
    from repro_torch.core.compressed_slab import CompressedSlab

    slabs = []
    for name, tables in (("trie", tm), ("store", store)):
        t0 = time.time()
        slab = CompressedSlab.build(tables)
        torch.cuda.synchronize()
        secs = time.time() - t0
        if name == "trie":
            m = memory_model.measure(tm, slab)
            comp, full = m["compressed_bytes"], m["sparse_bytes"]
        else:  # measure() needs n_constraints, which a store has per member
            rp = store.row_pointers.numel() * store.row_pointers.element_size()
            comp = rp + slab.nbytes()
            full = rp + store.edges.numel() * store.edges.element_size()
        ratio = comp / full
        log(f"  compressed slab of the {name}: {slab.tok_delta.dtype} deltas "
            f"{tuple(slab.tok_delta.shape)}, built in {secs:.2f}s on the card;"
            f" row pointers + slab {comp / 1e9:.3f} GB against {full / 1e9:.3f}"
            f" GB uncompressed ({ratio:.3f}x)")
        if slab.tok_delta.dtype != torch.int16:
            raise AssertionError(f"{name} slab is {slab.tok_delta.dtype}")
        if ratio > SLAB_GATE:
            raise AssertionError(f"{name} slab at {ratio:.3f}x the CSR bytes "
                                 f"(gate {SLAB_GATE})")
        slabs.append(slab)
    return slabs


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
KERNELS = {
    # name: (kernel, fused, TPU function it replaces)
    "vntk_topk": ("vntk_topk", False, "src/repro/kernels/vntk.py:1021"),
    "vntk_topk_fused": ("vntk_topk", True, "src/repro/kernels/vntk.py:1021"),
    "vntk_mask": ("vntk_mask", False, "src/repro/kernels/vntk.py:915"),
    "vntk_mask_fused": ("vntk_mask", True, "src/repro/kernels/vntk.py:940"),
    "vntk_stacked_topk": ("vntk_stacked_topk", False,
                          "src/repro/kernels/vntk.py:1198"),
    "vntk_stacked_topk_fused": ("vntk_stacked_topk", True,
                                "src/repro/kernels/vntk.py:1198"),
    "vntk_stacked_mask": ("vntk_stacked_mask", False,
                          "src/repro/kernels/vntk.py:965"),
    "vntk_stacked_mask_fused": ("vntk_stacked_mask", True,
                                "src/repro/kernels/vntk.py:993"),
    "vntk_compressed_topk": ("vntk_compressed_topk", False,
                             "src/repro/kernels/vntk.py:1126"),
    "vntk_compressed_topk_fused": ("vntk_compressed_topk", True,
                                   "src/repro/kernels/vntk.py:1126"),
    "vntk_compressed_mask": ("vntk_compressed_mask", False,
                             "src/repro/kernels/vntk.py:1054"),
    "vntk_compressed_mask_fused": ("vntk_compressed_mask", True,
                                   "src/repro/kernels/vntk.py:1054"),
    "vntk_stacked_compressed_topk": ("vntk_stacked_compressed_topk", False,
                                     "src/repro/kernels/vntk.py:1163"),
    "vntk_stacked_compressed_topk_fused": ("vntk_stacked_compressed_topk",
                                           True,
                                           "src/repro/kernels/vntk.py:1163"),
    "vntk_stacked_compressed_mask": ("vntk_stacked_compressed_mask", False,
                                     "src/repro/kernels/vntk.py:1091"),
    "vntk_stacked_compressed_mask_fused": ("vntk_stacked_compressed_mask",
                                           True,
                                           "src/repro/kernels/vntk.py:1091"),
}
VNTK_SOURCE = "src/repro_torch/kernels/csrc/vntk.cu"


def n_child(rp, nodes, cids=None) -> np.ndarray:
    """Children of each row's node (of its member when stacked)."""
    n = nodes.long()
    if cids is None:
        return (rp[n + 1] - rp[n]).cpu().numpy()
    k = cids.long().clamp(0, rp.shape[0] - 1)
    return (rp[k, n + 1] - rp[k, n]).cpu().numpy()


def needed_bytes(topk, fused, stacked, children, bmax, V, width,
                 edge_bytes=8, base_bytes=0) -> int:
    """Bytes the function must move for these inputs: the constraint ids
    (stacked), the nodes, the row-pointer pairs and valid edges it reads
    (``edge_bytes`` each: an int32 pair, or one delta of a compressed slab,
    whose next-state bases are ``base_bytes``), the log-probs of the valid
    slots (the whole row when it normalizes), and its outputs, each once."""
    n_real = int(np.minimum(np.maximum(children, 0), bmax).sum())
    nb = children.shape[0]
    reads = nb * 4 * (2 if stacked else 1) + nb * 8 + n_real * edge_bytes
    reads += base_bytes + (nb * V * 4 if fused else n_real * 4)
    writes = nb * width * 12 if topk else nb * V * 8
    return reads + writes


class KernelCheck:
    """Runs one kernel function and its plain version on the same inputs.

    ``tables`` is ``(row_pointers, edges)``, or ``(row_pointers, tok_delta,
    base)`` for a compressed-slab function."""

    def __init__(self, name):
        from repro_torch.kernels import vntk as kv

        self.name = name
        self.kernel, self.fused, self.replaces = KERNELS[name]
        self.stacked = "stacked" in self.kernel
        self.topk = self.kernel.endswith("topk")
        self.compressed = "compressed" in self.kernel
        self.cuda = getattr(kv, f"{self.kernel}_cuda")
        self.plain = getattr(kv, f"{self.kernel}_plain")
        self.max_abs_err = 0.0
        self.times = []  # (ms, plain_ms, bound_ms) per main-path level
        self.paths = []  # the route taken at each main-path level
        self.routes = set()  # the routes the comparisons took

    def path(self, bmax):
        """The kernel's route for rows of ``bmax`` slots: ``warp`` or
        ``block``."""
        from repro_torch.kernels import vntk as kv

        return kv.topk_path(bmax) if self.topk else kv.mask_path(bmax)

    def args(self, values, nodes, cids, tables, bmax, V, width):
        head = (values, nodes) + ((cids,) if self.stacked else ())
        return (head + tuple(tables) + (bmax, V)
                + ((width,) if self.topk else ()) + (self.fused,))

    def compare(self, label, *a, want=None):
        """Kernel against the plain version (or against ``want``, the
        outputs of another kernel on the same rows)."""
        self.routes.add(self.path(a[4]))
        a = self.args(*a)
        got = self.cuda(*a)
        want = self.plain(*a) if want is None else want
        torch.cuda.synchronize()
        for g, w in zip(got[1:], want[1:]):  # tokens / next states
            if not torch.equal(g, w.to(g.dtype)):
                raise AssertionError(f"{self.name} [{label}]: integer outputs "
                                     "differ")
        g, w = got[0], want[0].float()
        err = float((g - w).abs().max()) if g.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        ok = (torch.allclose(g, w, rtol=1e-5, atol=1e-5) if self.fused
              else torch.equal(g, w))
        if not ok:
            raise AssertionError(f"{self.name} [{label}]: scores differ "
                                 f"(max abs err {err:g})")
        return got

    def compare_twin(self, label, values, nodes, cids, tables, pairs, bmax, V,
                     width):
        """A compressed function against the plain version and, bit for
        bit, against its uncompressed twin kernel over ``pairs``
        (``(row_pointers, edges)`` of the same trie)."""
        from repro_torch.kernels import vntk as kv

        got = self.compare(label, values, nodes, cids, tables, bmax, V, width)
        twin = getattr(kv, self.kernel.replace("_compressed", "") + "_cuda")
        head = (values, nodes) + ((cids,) if self.stacked else ())
        want = twin(*head, *pairs, bmax, V, *((width,) if self.topk else ()),
                    self.fused)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{self.name} [{label}]: differs from its "
                                 "uncompressed twin kernel")
        return got

    def time(self, values, nodes, cids, tables, bmax, V, width):
        a = self.args(values, nodes, cids, tables, bmax, V, width)
        ms = device_ms(lambda: self.cuda(*a))
        plain_ms = device_ms(lambda: self.plain(*a), iters=10)
        children = n_child(tables[0], nodes, cids if self.stacked else None)
        edge_bytes, base_bytes = 8, 0
        if self.compressed:
            edge_bytes = tables[1].element_size()
            base_bytes = 4 * tables[2].numel()
        bound = needed_bytes(self.topk, self.fused, self.stacked, children,
                             bmax, V, width, edge_bytes,
                             base_bytes) / HBM_BYTES_PER_S * 1e3
        self.times.append((ms, plain_ms, bound))
        self.paths.append(self.path(bmax))

    def main_path(self) -> str:
        """The route(s) of the main-path levels, e.g. ``warp``."""
        return "+".join(sorted(set(self.paths)))

    def summary(self, levels):
        ms, plain_ms, bound = np.mean(self.times, axis=0)
        twin = " and its uncompressed twin" if self.compressed else ""
        if self.routes != {"warp", "block"}:
            raise AssertionError(f"{self.name}: compared on the routes "
                                 f"{sorted(self.routes)}, not on both")
        log(f"  {self.name}: equal to plain{twin} at levels {levels} and "
            f"stress shapes (route {'+'.join(sorted(self.routes))}); "
            f"max abs err {self.max_abs_err:.3g}; {ms * 1e3:.2f} us (plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us) per launch, "
            f"mean over levels, {self.main_path()} route")


def level_nodes(rng, offsets, level, nb):
    lo, hi = int(offsets[level]), int(offsets[level + 1])
    return rng.integers(lo, hi, nb).astype(np.int32)


def make_values(rng, nb, V, fused, ties=False):
    """Raw logits (fused) or log-probs; bf16-rounded like the model's
    logits, or quantized to multiples of 0.5 for heavy ties."""
    x = torch.from_numpy(rng.normal(size=(nb, V)).astype(np.float32) * 4)
    x = (x * 2).round() / 2 if ties else x.to(torch.bfloat16).float()
    x = x.cuda()
    return x if fused else torch.log_softmax(x, dim=-1)


def special_values(rng, nb, V, fused):
    """:func:`make_values` with a quarter of the columns at -inf and a
    quarter at NEG_INF (and, as log-probs, an eighth at -FLT_MAX): valid
    slots whose keys tie with the missing and padding candidates', or fall
    below them."""
    from repro_torch.core.vntk import NEG_INF

    x = make_values(rng, nb, V, fused)
    cols = torch.from_numpy(rng.permutation(V)).cuda()
    x[:, cols[:V // 4]] = -float("inf")
    x[:, cols[V // 4:V // 2]] = NEG_INF
    if not fused:
        x[:, cols[V // 2:5 * V // 8]] = torch.finfo(torch.float32).min
    return x


def cuda_ints(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()


def phase_kernels(rng, idx, M, checks):
    """The single-matrix functions at the single path's shapes and stress
    shapes; the compressed ones over the slab, against their twins too."""
    from repro_torch.core.compressed_slab import CompressedSlab
    from repro_torch.core.trie import build_flat_trie
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.vntk import candidate_width

    ft, tm, slab = idx["ft"], idx["tm"], idx["slab"]
    V, L, d = ft.vocab_size, ft.sid_length, ft.dense_d
    nb, C = 2 * M, candidate_width(M, ft.vocab_size)
    # the root row of a dense_d=0 trie: one CSR row of every first token
    sids = idx["sids"]  # ~200k of them, spread over the sorted catalog
    ft0 = build_flat_trie(sids[::max(1, len(sids) // 200_000)], V, dense_d=0)
    tm0 = TransitionMatrix.from_flat_trie(ft0, device="cuda")
    slab0 = CompressedSlab.from_matrix(tm0)
    # an int32 slab: 200k SIDs of length 3 over V = 40000 > 32768, dense_d=0
    Vb = 40_000
    ftb = build_flat_trie(rng.integers(0, Vb, (200_000, 3)), Vb, dense_d=0)
    tmb = TransitionMatrix.from_flat_trie(ftb, device="cuda")
    slabb = CompressedSlab.from_matrix(tmb)
    if slabb.tok_delta.dtype != torch.int32:
        raise AssertionError(f"V={Vb} slab is {slabb.tok_delta.dtype}")
    # V = 64 and 62: level-1 rows of ~30-40 children, cut at a bmax of 32
    small = {V_: small_tables(rng, V_, (3000,)) for V_ in (64, 62)}

    def tables(step, t=tm, sl=slab):  # what the function reads at `step`
        return ((t.row_pointers, sl.tok_delta, sl.base_for_step(step))
                if chk.compressed else (t.row_pointers, t.edges))

    def compare(label, values, nodes, bmax, V_=V, *, step, t=tm, sl=slab,
                width=C):
        tab, pr = tables(step, t, sl), (t.row_pointers, t.edges)
        if chk.compressed:
            return chk.compare_twin(label, values, nodes, None, tab, pr, bmax,
                                    V_, width)
        return chk.compare(label, values, nodes, None, tab, bmax, V_, width)

    for chk in checks:
        for level in range(d, L):
            bmax = int(ft.level_bmax[level])
            nodes = cuda_ints(level_nodes(rng, ft.level_offsets, level, nb))
            values = make_values(rng, nb, V, chk.fused)
            compare(f"level {level}", values, nodes, bmax, V, step=level)
            chk.time(values, nodes, None, tables(level), bmax, V, C)
        # stress: prime row count with a quarter of the rows at the sink,
        # tie-heavy values, and a bmax >= 512 root row
        nodes_np = level_nodes(rng, ft.level_offsets, d, 139)
        nodes_np[rng.random(139) < 0.25] = 0
        values = make_values(rng, 139, V, chk.fused, ties=True)
        compare("prime nb, sink rows, ties", values, cuda_ints(nodes_np),
                int(ft.level_bmax[d]), V, step=d)
        bmax0 = int(ft0.level_bmax[0])
        if bmax0 < 512:
            raise AssertionError(f"stress root row has bmax {bmax0} < 512")
        nodes_np = np.ones(nb, np.int32)
        nodes_np[::7] = 0
        compare(f"bmax {bmax0} root row", make_values(rng, nb, V, chk.fused),
                cuda_ints(nodes_np), bmax0, V, step=0, t=tm0, sl=slab0)
        for bmax in (32, 33):  # one warp with all 32 lanes real; the block
            compare(f"root row cut to bmax {bmax}",
                    make_values(rng, nb, V, chk.fused), cuda_ints(nodes_np),
                    bmax, V, step=0, t=tm0, sl=slab0)
        for V_, (offsets, t_, sl_) in small.items():
            if chk.topk and V_ == 64:
                warp_minf_rows(compare, rng, chk, offsets, None, t=t_,
                               sl=sl_)
            elif not chk.topk:
                mask_small_rows(compare, rng, chk, offsets, None, V_, t=t_,
                                sl=sl_)
        if chk.fused:  # rows 4 bytes off 16: the scalar loads
            compare("logit rows off 16-byte alignment",
                    make_values(rng, nb, V + 1, True)[:, 1:],
                    cuda_ints(level_nodes(rng, ft.level_offsets, d, nb)),
                    int(ft.level_bmax[d]), V, step=d)
        if chk.compressed:  # the int32 slab: its root row (mask; a ~40k-slot
            # topk row overflows smem, so cut to 4096 slots) and level 1
            for step in ((0, 1) if chk.topk else (0,)):
                nodes_np = level_nodes(rng, ftb.level_offsets, step, nb)
                nodes_np[::5] = 0
                bmax = int(ftb.level_bmax[step])
                if chk.topk and step == 0:
                    bmax = 4096
                compare(f"int32 slab, V={Vb}, step {step}, bmax {bmax}",
                        make_values(rng, nb, Vb, chk.fused),
                        cuda_ints(nodes_np), bmax, Vb, step=step, t=tmb,
                        sl=slabb)
        chk.summary(f"{d}-{L - 1}")
    log(f"  int32 slab: V={Vb}, {tmb.n_edges} edges, root row of "
        f"{int(ftb.level_bmax[0])} slots")


def small_tables(rng, V, counts):
    """Tries over V tokens of ``counts`` random length-3 SIDs each
    (dense_d=0) on the card: ``(level offsets, matrix, slab)`` for one, or
    ``(their level offsets, store, slab)`` for several."""
    from repro_torch.constraints import ConstraintStore
    from repro_torch.core.compressed_slab import CompressedSlab
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.trie import build_flat_trie

    fts = [build_flat_trie(rng.integers(0, V, (n, 3)), V, dense_d=0)
           for n in counts]
    mats = [TransitionMatrix.from_flat_trie(f, device="cuda") for f in fts]
    if len(mats) == 1:
        return fts[0].level_offsets, mats[0], CompressedSlab.from_matrix(
            mats[0])
    store = ConstraintStore.from_matrices(mats, device="cuda")
    return ([f.level_offsets for f in fts], store,
            CompressedSlab.from_store(store))


def small_rows(rng, offsets, cids, nb=67):
    """Level-1 rows of a small trie (of a member per id when ``cids`` are
    given), every sixth at the sink: ``(nodes, head)``, ``head`` holding
    the ids on the card when stacked."""
    if cids is None:
        nodes_np, head = level_nodes(rng, offsets, 1, nb), ()
    else:
        ids = np.resize(cids, nb).astype(np.int32)
        nodes_np, head = stacked_rows(rng, offsets, ids, 1), (cuda_ints(ids),)
    nodes_np[::6] = 0
    return cuda_ints(nodes_np), head


def warp_minf_rows(compare, rng, chk, offsets, cids, **tables):
    """A topk function on the warp route at V = width = 64: level-1 rows
    (of a member per id when ``cids`` are given; some at the sink) cut to
    bmax 32, valid log-probs at NEG_INF and -inf (-FLT_MAX too when not
    fused), so candidates at -FLT_MAX reach the output."""
    nodes, head = small_rows(rng, offsets, cids)
    got = compare("V=64, width 64, log-probs at NEG_INF, -inf",
                  special_values(rng, nodes.shape[0], 64, chk.fused), nodes,
                  *head, 32, step=1, V_=64, width=64, **tables)
    if not bool((got[0] == torch.finfo(torch.float32).min).any()):
        raise AssertionError(f"{chk.name}: no -FLT_MAX candidate written")


def mask_small_rows(compare, rng, chk, offsets, cids, V, **tables):
    """A mask function on both paths over a small trie of V tokens:
    level-1 rows (of a member per id when ``cids`` are given; some at the
    sink) cut to bmax 32 and 33, valid values at NEG_INF, -inf and (not
    fused) -FLT_MAX.  At V = 62 (V % 4 != 0) the row's loads and the fill
    take their scalar code."""
    for bmax in (32, 33):
        nodes, head = small_rows(rng, offsets, cids)
        compare(f"V={V}, bmax {bmax}, values at NEG_INF, -inf",
                special_values(rng, nodes.shape[0], V, chk.fused), nodes,
                *head, bmax, step=1, V_=V, width=V, **tables)


def latency_floor(rng, idx):
    """One launch of each VNTK kernel with little but the load chain to do:
    ``vntk_topk_cuda`` (width = 8) and ``vntk_mask_cuda`` (its V-wide fill
    besides) at nb = 1, bmax = 1, not fused, on a row of the deepest level,
    checked against the plain version and timed as the kernel rows are."""
    from repro_torch.kernels import vntk as kv

    ft, tm = idx["ft"], idx["tm"]
    V = ft.vocab_size
    nodes = cuda_ints(level_nodes(rng, ft.level_offsets, ft.sid_length - 1, 1))
    head = (make_values(rng, 1, V, False), nodes, tm.row_pointers, tm.edges,
            1, V)
    for kernel, path, tail in (("vntk_topk", kv.topk_path(1), (8,)),
                               ("vntk_mask", kv.mask_path(1), ())):
        cuda = getattr(kv, f"{kernel}_cuda")
        args = head + tail
        got, want = cuda(*args), getattr(kv, f"{kernel}_plain")(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{kernel} latency floor launch differs "
                                 "from plain")
        ms = device_ms(lambda: cuda(*args))
        log(f"  latency floor: {kernel} ({path} {'route' if tail else 'path'})"
            f" at nb=1, bmax=1{', width=8' if tail else ''}, not fused: "
            f"{ms * 1e3:.2f} us per launch")


def stacked_rows(rng, offsets, cids, level):
    """One node per row from its own member's level range."""
    return np.array([level_nodes(rng, offsets[min(max(k, 0), len(offsets) - 1)],
                                 level, 1)[0] for k in cids], np.int32)


def phase_stacked_kernels(rng, idx, M, checks, full_size):
    """The stacked functions at the stacked path's shapes, stress shapes and
    the 64-bit member offset stress (which passes 2^31 int32 elements only
    at the full catalog size); the compressed ones over the store's slab,
    against their twins too."""
    from repro_torch.constraints import ConstraintStore
    from repro_torch.core.compressed_slab import CompressedSlab
    from repro_torch.core.vntk import candidate_width
    from repro_torch.kernels import vntk as kv

    store, offsets, ft = idx["store"], idx["level_offsets"], idx["ft"]
    V, L, d, K = store.vocab_size, store.sid_length, store.dense_d, store.num_sets
    nb, C = K * M, candidate_width(M, V)
    cids_np = np.repeat(np.arange(K, dtype=np.int32), M)  # a request per slot
    # two members over V = 64 and 62: level-1 rows of ~30-40 children, cut
    # at bmax 32; and two over V (dense_d=0), whose root rows hold ~2000
    small = {V_: small_tables(rng, V_, (3000, 2000)) for V_ in (64, 62)}
    wide = small_tables(rng, V, (20_000, 10_000))

    def tables(step, st=store, sl=idx["store_slab"]):
        return ((st.row_pointers, sl.tok_delta, sl.base_for_step(step))
                if chk.compressed else (st.row_pointers, st.edges))

    def compare(label, values, nodes, cids, bmax, step, st=store,
                sl=idx["store_slab"], want=None, width=C, V_=V):
        tab, pr = tables(step, st, sl), (st.row_pointers, st.edges)
        if chk.compressed and want is None:
            return chk.compare_twin(label, values, nodes, cids, tab, pr, bmax,
                                    V_, width)
        return chk.compare(label, values, nodes, cids, tab, bmax, V_, width,
                           want=want)

    for chk in checks:
        for level in range(d, L):
            bmax = store.bmax_for_step(level)
            nodes = cuda_ints(stacked_rows(rng, offsets, cids_np, level))
            values = make_values(rng, nb, V, chk.fused)
            cids = cuda_ints(cids_np)
            compare(f"level {level}", values, nodes, cids, bmax, level)
            chk.time(values, nodes, cids, tables(level), bmax, V, C)
        # stress: prime nb, mixed ids (two out of range: the kernel clamps
        # them as the plain version does), a quarter at the sink, ties
        stress = rng.integers(0, K, 349).astype(np.int32)
        stress[:2] = (-1, K + 2)
        nodes_np = stacked_rows(rng, offsets, stress, d)
        nodes_np[rng.random(349) < 0.25] = 0
        compare("prime nb, sink rows, clamped ids, ties",
                make_values(rng, 349, V, chk.fused, ties=True),
                cuda_ints(nodes_np), cuda_ints(stress),
                store.bmax_for_step(d), d)
        if chk.topk:  # the same rows at bmax 32 (warp) and 64 (block)
            for bmax in (32, 64):
                compare(f"prime nb, sink rows, clamped ids, bmax {bmax}",
                        make_values(rng, 349, V, chk.fused),
                        cuda_ints(nodes_np), cuda_ints(stress), bmax, d)
            offsets64, store64, slab64 = small[64]
            warp_minf_rows(compare, rng, chk, offsets64, [0, 1], st=store64,
                           sl=slab64)
        else:  # each member's root row cut to bmax 32 (warp) and 33 (block)
            roots = cuda_ints(stacked_rows(rng, wide[0], stress, 0))
            for bmax in (32, 33):
                compare(f"root rows, clamped ids, bmax {bmax}",
                        make_values(rng, 349, V, chk.fused), roots,
                        cuda_ints(stress), bmax, 0, st=wide[1], sl=wide[2])
            for V_, (offsets_, st_, sl_) in small.items():
                mask_small_rows(compare, rng, chk, offsets_, [0, 1], V_,
                                st=st_, sl=sl_)
        if chk.fused:  # rows 4 bytes off 16: the scalar loads
            compare("logit rows off 16-byte alignment",
                    make_values(rng, 349, V + 1, True)[:, 1:],
                    cuda_ints(nodes_np), cuda_ints(stress),
                    store.bmax_for_step(d), d)
    # offset stress: ten copies of the trie at headroom 0; rows on the last
    # member's deepest level, whose edges lie past 2^31 int32 elements
    t0 = time.time()
    big = ConstraintStore.from_matrices([idx["tm"]] * 10, headroom=0.0,
                                        device="cuda")
    big_slab = CompressedSlab.from_store(big)
    torch.cuda.synchronize()
    deep = L - 1
    nodes = cuda_ints(level_nodes(rng, ft.level_offsets, deep, nb))
    cids = torch.full_like(nodes, 9)
    first = int(big.row_pointers[9, nodes.long()].min())
    elem = 9 * big.edges.shape[1] * 2 + 2 * first
    if full_size and elem < 2 ** 31:
        raise AssertionError(f"offset stress reaches only int32 element {elem}")
    bmax = big.bmax_for_step(deep)
    tm, slab = idx["tm"], idx["slab"]
    for chk in checks:
        values = make_values(rng, nb, V, chk.fused)
        single = getattr(kv, chk.kernel.replace("_stacked", "") + "_cuda")
        one = ((tm.row_pointers, slab.tok_delta, slab.base_for_step(deep))
               if chk.compressed else (tm.row_pointers, tm.edges))
        want = single(values, nodes, *one, bmax, V,
                      *((C,) if chk.topk else ()), chk.fused)
        compare("offset stress vs single-matrix kernel", values, nodes, cids,
                bmax, deep, big, big_slab, want=want)
        compare("offset stress vs plain", values, nodes, cids, bmax, deep,
                big, big_slab)
        chk.summary(f"{d}-{L - 1}")
    delta_bytes = 9 * big_slab.tok_delta.shape[1] * 2 + 2 * first
    log(f"  offset stress: {big.nbytes() / 1e9:.3f} GB store of 10 members "
        f"and its {big_slab.nbytes() / 1e9:.3f} GB slab, rows on member 9's "
        f"level {deep} from int32 element {elem} "
        f"({'past' if elem >= 2 ** 31 else 'below'} 2^31) and slab byte "
        f"{delta_bytes} ({'past' if delta_bytes >= 2 ** 31 else 'below'} "
        f"2^31) equal to the single-matrix kernels ({time.time() - t0:.1f}s)")
    del big, big_slab
    torch.cuda.empty_cache()


def phase_golden():
    """Replay tests/golden through the kernels, and the §5.2 baselines'
    traces with their tables on the card: trace tokens must equal the
    frozen reference traces and scores agree within rtol 1e-6 (1e-5 when
    the kernel normalizes)."""
    from repro_torch.constraints import ConstraintStore
    from repro_torch.core.beam_search import beam_search
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.decoding import DecodePolicy

    golden = os.path.join(HERE, "tests", "golden")
    inputs = np.load(os.path.join(golden, "inputs.npz"))
    traces = np.load(os.path.join(golden, "traces.npz"))
    table = torch.from_numpy(inputs["table"]).cuda()
    V, B, M = table.shape[-1], 2, 4
    L = table.shape[0]
    tm = TransitionMatrix.load(os.path.join(golden, "trie_small.npz"))
    tm_d0 = TransitionMatrix.from_sids(inputs["sids"], V, dense_d=0)
    store = ConstraintStore.from_matrices(
        [TransitionMatrix.from_sids(inputs["decoy"], V, dense_d=2), tm],
        headroom=0.2)  # regenerate.py's store; every row on member 1

    def logits_fn(carry, last, step):
        return table[step][last.long()], carry

    ones = np.ones(B, np.int32)
    sids = inputs["sids"]
    for name, policy in (  # regenerate.py's baselines, tables on the card
            ("ppv_exact", DecodePolicy.ppv(sids, V, exact=True)),
            ("cpu_trie", DecodePolicy.cpu_trie(sids, V)),
            ("hash_bitmap", DecodePolicy.hash_bitmap(sids, V, log2_bits=22))):
        for topk in (True, False):  # no candidate step: both vocab-aligned
            _, _, tr = beam_search(logits_fn, None, B, M, L,
                                   policy.with_topk(topk), return_trace=True,
                                   device="cuda")
            label = f"golden {name} topk={topk}"
            if not np.array_equal(tr.tokens.cpu().numpy(),
                                  traces[f"{name}_trace_tokens"]):
                raise AssertionError(f"{label}: trace tokens")
            np.testing.assert_allclose(tr.scores.cpu().numpy(),
                                       traces[f"{name}_trace_scores"],
                                       err_msg=label, rtol=1e-6)
    for compressed in (False, True):
        for name, policy, trace, cids in (
                ("static", DecodePolicy.static(tm, compressed=compressed),
                 "static", None),
                ("static_fused", DecodePolicy.static(
                    tm, fused=True, compressed=compressed), "static_fused",
                 None),
                ("static_d0", DecodePolicy.static(tm_d0,
                                                  compressed=compressed),
                 "static_d0", None),
                ("stacked", DecodePolicy.stacked(store, compressed=compressed),
                 "stacked", ones),
                ("stacked_fused", DecodePolicy.stacked(
                    store, fused=True, compressed=compressed), "stacked",
                 ones)):
            for topk in (True, False):
                _, _, tr = beam_search(logits_fn, None, B, M, L,
                                       policy.with_topk(topk),
                                       constraint_ids=cids, return_trace=True)
                label = f"golden {name} topk={topk} compressed={compressed}"
                if not np.array_equal(tr.tokens.cpu().numpy(),
                                      traces[f"{trace}_trace_tokens"]):
                    raise AssertionError(f"{label}: trace tokens")
                tol = (dict(rtol=1e-5, atol=1e-5) if "fused" in name
                       else dict(rtol=1e-6))  # the fused kernel's own lse
                np.testing.assert_allclose(tr.scores.cpu().numpy(),
                                           traces[f"{trace}_trace_scores"],
                                           err_msg=label, **tol)
    log("  golden traces static/static_fused/static_d0/stacked (and stacked "
        "through the fused kernels; topk and dense advance; without and with "
        "the compressed slab) reproduced through the kernels; ppv_exact/"
        "cpu_trie/hash_bitmap on the card")


def phase_attention(rng):
    """The bf16 attention products on the card (float32 results of bf16
    operands) against the same functions on the CPU (exact upcasts, held
    against the JAX reference by tests/test_torch_transformer.py).

    cuBLAS sums the float32 scores in another order than the CPU, so a
    probability near a bf16 rounding boundary can round the other way when
    it is cast for the PV product, and the output's own bf16 rounding can
    then flip too.  Hence the tolerance: 1e-4 on average, and per element at
    most one bf16 ulp in [2, 4) (2**-6; early prefill rows average a few
    unit-normal values and reach that range).  Scores rounded to bf16 before
    the softmax, the fault this guards against, are off by ~2e-2 at most
    and ~3e-3 on average."""
    from repro_torch.models import attention

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(torch.bfloat16)

    def diff(got, want):
        d = (got.float().cpu() - want.float()).abs()
        return float(d.max()), float(d.mean())

    q, k, v = bf16(8, 1, 24, 128), bf16(8, 265, 8, 128), bf16(8, 265, 8, 128)
    pos = torch.arange(265)
    want = attention.decode_attention(q, k, v, pos, 264)
    got = attention.decode_attention(q.cuda(), k.cuda(), v.cuda(), pos.cuda(),
                                     264)
    dec = diff(got, want)
    q, k, v = bf16(2, 256, 24, 128), bf16(2, 256, 8, 128), bf16(2, 256, 8, 128)
    want = attention.chunked_causal_attention(q, k, v)
    got = attention.chunked_causal_attention(q.cuda(), k.cuda(), v.cuda())
    pre = diff(got, want)
    log(f"  bf16 attention on the card vs the CPU: decode max/mean abs diff "
        f"{dec[0]:g}/{dec[1]:g}, prefill {pre[0]:g}/{pre[1]:g}")
    if max(dec[0], pre[0]) > 2.0 ** -6 or max(dec[1], pre[1]) >= 1e-4:
        raise AssertionError("bf16 attention products differ from the CPU's")


# ---------------------------------------------------------------------------
# phases 4-5: the main paths
# ---------------------------------------------------------------------------
def check_batch(name, beams, scores, shape):
    if beams.shape != shape or not np.all(np.isfinite(scores)):
        raise AssertionError(f"{name}: bad output shape/scores")
    if np.any(np.diff(scores, axis=1) > 0):
        raise AssertionError(f"{name}: beams not score-sorted")


def check_compliance(name, sorted_sids, beams, scores):
    from repro_torch.launch.serve import compliance

    members, live = compliance(sorted_sids, beams, scores)
    if members != live or live == 0:
        raise AssertionError(f"{name}: {members}/{live} live beams in the "
                             "constraint set")


def run_policies(policies, make_retriever, hists, check, n_sparse):
    """Serve every batch under every policy; returns the first batch's
    outputs and the median retrieve ms per policy.  Each policy must launch
    its counter exactly ``n_sparse`` times per retrieve and nothing else."""
    from repro_torch.kernels import vntk as kv

    first, median_ms = {}, {}
    for name, (policy, counter) in policies.items():
        r = make_retriever(policy)
        before = dict(kv.LAUNCHES)
        lat = []
        for i, hist in enumerate(hists):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beams, scores = r(hist)  # host arrays: synchronized
            if i:
                lat.append(time.perf_counter() - t0)
            else:
                first[name] = (beams, scores)
            check(name, beams, scores)
        rose = {k: kv.LAUNCHES[k] - before[k] for k in kv.LAUNCHES}
        want = {k: (n_sparse * len(hists) if k == counter else 0) for k in rose}
        if rose != want:
            raise AssertionError(f"{name}: launches {rose}, expected {want}")
        median_ms[name] = float(np.median(lat)) * 1e3
        log(f"  {name} [{policy.describe()}]: median retrieve "
            f"{median_ms[name]:.2f} ms over {len(lat)} batches; 100% "
            f"compliance; {counter} launched {n_sparse} times per retrieve")
    return first, median_ms


def plain_policy(policy):
    """``policy`` with the plain constraint step on its sparse levels (its
    compressed slab, if any, kept)."""
    return dataclasses.replace(policy, backends=tuple(
        b if b.levels == "dense" else dataclasses.replace(b, impl="plain")
        for b in policy.backends))


def check_twins(first):
    """Each compressed policy's first batch equals its uncompressed twin's
    (``<path>_slab<flags>`` against ``<path><flags>``), bit for bit."""
    for name, (beams, scores) in first.items():
        if "_slab" not in name:
            continue
        twin = first[name.replace("_slab", "")]
        if not (np.array_equal(beams, twin[0])
                and np.array_equal(scores, twin[1])):
            raise AssertionError(f"{name}: SIDs or scores differ from the "
                                 "uncompressed policy's")
        log(f"  {name}: SIDs and scores bit-equal to "
            f"{name.replace('_slab', '')}'s over the same batch")


def with_slab_twins(policies, make, tables, path, counter):
    """``policies`` (the four uncompressed ones of ``path``), each followed
    by its compressed twin built through the entry point ``make`` (a slab
    each), so the two run in turns; values are (policy, counter it must
    reach)."""
    t0 = time.time()
    slabbed = {
        f"{path}_slab": (make(tables, compressed=True), counter),
        f"{path}_slab_fused": (make(tables, fused=True, compressed=True),
                               f"{counter}_fused"),
        f"{path}_slab_notopk": (make(tables, topk=False, compressed=True),
                                counter.replace("topk", "mask")),
        f"{path}_slab_fused_notopk": (
            make(tables, fused=True, topk=False, compressed=True),
            counter.replace("topk", "mask") + "_fused"),
    }
    torch.cuda.synchronize()
    log(f"  four compressed {path} policies built in "
        f"{time.time() - t0:.1f}s (a slab each)")
    return dict(kv for pair in zip(policies.items(), slabbed.items())
                for kv in pair)


def phase_single(args, rng, params, cfg, idx):
    from repro_torch.configs import static_gr
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.models import transformer
    from repro_torch.serving import GenerativeRetriever

    tm = idx["tm"]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        params = dict(params, layers=params["layers"][:args.layers])
    L, V, M, B = (static_gr.SID_LENGTH, static_gr.SID_VOCAB,
                  static_gr.BEAM_SIZE, 2)
    log(f"  {cfg.name}: {cfg.n_layers} layers, B={B}, M={M}, L={L}")
    hists = [rng.integers(0, cfg.vocab_size, (B, static_gr.HISTORY_LEN))
             for _ in range(args.batches + 1)]
    policies = {  # name: (policy, kernel counter it must reach)
        "static": (DecodePolicy.static(tm), "vntk_topk"),
        "static_fused": (DecodePolicy.static(tm, fused=True),
                         "vntk_topk_fused"),
        "static_notopk": (DecodePolicy.static(tm, topk=False), "vntk_mask"),
        "static_fused_notopk": (DecodePolicy.static(tm, fused=True, topk=False),
                                "vntk_mask_fused"),
    }
    policies = with_slab_twins(policies, DecodePolicy.static, tm, "static",
                               "vntk_compressed_topk")

    def check(name, beams, scores):
        check_batch(name, beams, scores, (B, M, L))
        check_compliance(name, idx["sorted_sids"], beams, scores)

    def make(policy):
        r = GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)
        return r.retrieve

    kv.reset_launches()  # the single path's run starts here
    first, median_ms = run_policies(policies, make, hists, check, L - tm.dense_d)
    launches = dict(kv.LAUNCHES)  # ... and ends here
    for _, counter in policies.values():
        if launches[counter] == 0:
            raise AssertionError(f"{counter} never launched on the single path")

    # per-step split of one retrieve: prefill alone vs the whole retrieve
    hist_t = torch.as_tensor(hists[1], device=params["emb"].device)
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            transformer.prefill(params, hist_t, cfg,
                                max_len=static_gr.HISTORY_LEN + L + 1)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    pre_ms = float(np.median(pre)) * 1e3
    log(f"  prefill (B={B}, S={static_gr.HISTORY_LEN}) median {pre_ms:.2f} "
        f"ms; per decode step (static: retrieve minus prefill over {L - 1} "
        f"steps) {(median_ms['static'] - pre_ms) / (L - 1):.2f} ms")

    check_twins(first)

    # the same batch with the plain constraint step on the same card/model
    for name in ("static", "static_notopk", "static_slab",
                 "static_slab_notopk"):
        beams, scores = make(plain_policy(policies[name][0]))(hists[0])
        if not (np.array_equal(beams, first[name][0])
                and np.array_equal(scores, first[name][1])):
            raise AssertionError(f"{name}: plain constraint step disagrees")
        log(f"  {name}: plain constraint step gives equal SIDs and scores")

    if args.profile:
        for name in ("static", "static_slab"):
            r = GenerativeRetriever(params, cfg, policies[name][0], L, V,
                                    beam_size=M)
            log(f"  profile of {name}:")
            profile_retrieve(lambda: r.retrieve(hists[1]), median_ms[name])
    return launches, dict(params=params, cfg=cfg, hists=hists, first=first)


def phase_stacked(args, rng, params, cfg, idx):
    from repro_torch.configs import static_gr
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.trie import build_flat_trie
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.serving import GenerativeRetriever

    store = idx["store"]
    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    B = store.num_sets
    cids = np.arange(B, dtype=np.int32)  # request i under slot i
    log(f"  {cfg.name}: {cfg.n_layers} layers, B={B} (one request per "
        f"slot), M={M}, L={L}")
    hists = [rng.integers(0, cfg.vocab_size, (B, static_gr.HISTORY_LEN))
             for _ in range(args.batches + 1)]
    policies = {
        "stacked": (DecodePolicy.stacked(store), "vntk_stacked_topk"),
        "stacked_fused": (DecodePolicy.stacked(store, fused=True),
                          "vntk_stacked_topk_fused"),
        "stacked_notopk": (DecodePolicy.stacked(store, topk=False),
                           "vntk_stacked_mask"),
        "stacked_fused_notopk": (DecodePolicy.stacked(store, fused=True,
                                                      topk=False),
                                 "vntk_stacked_mask_fused"),
    }
    policies = with_slab_twins(policies, DecodePolicy.stacked, store,
                               "stacked", "vntk_stacked_compressed_topk")
    slot_sids = list(idx["slot_sids"])

    def check(name, beams, scores):
        check_batch(name, beams, scores, (B, M, L))
        for i in range(B):
            check_compliance(f"{name} row {i}", slot_sids[i],
                             beams[i:i + 1], scores[i:i + 1])

    def make(policy):
        r = GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)
        return lambda hist: r.retrieve(hist, cids)

    n_sparse = L - store.dense_d
    kv.reset_launches()  # the stacked path's run starts here
    first, median_ms = run_policies(policies, make, hists, check, n_sparse)
    launches = dict(kv.LAUNCHES)  # ... and ends here
    for _, counter in policies.values():
        if launches[counter] == 0:
            raise AssertionError(f"{counter} never launched on the stacked "
                                 "path")

    # row 0 against the single-matrix retrieve over member 0, same batch
    beams, scores = GenerativeRetriever(
        params, cfg, DecodePolicy.static(store.member(0)), L, V,
        beam_size=M).retrieve(hists[0])
    if not (np.array_equal(beams[0], first["stacked"][0][0])
            and np.array_equal(scores[0], first["stacked"][1][0])):
        raise AssertionError("stacked row 0 differs from the single-matrix "
                             "retrieve over store.member(0)")
    log("  stacked row 0 bit-equal to DecodePolicy.static(store.member(0)) "
        "over the same batch")

    check_twins(first)

    for name in ("stacked", "stacked_notopk", "stacked_slab",
                 "stacked_slab_notopk"):
        beams, scores = make(plain_policy(policies[name][0]))(hists[0])
        if not (np.array_equal(beams, first[name][0])
                and np.array_equal(scores, first[name][1])):
            raise AssertionError(f"{name}: plain constraint step disagrees")
        log(f"  {name}: plain constraint step gives equal SIDs and scores")

    # hot swap: re-age the catalog and rebuild fresh_22 into slot 0, under
    # the default policy and under the compressed one (which rebuilds its
    # slab for the new store)
    policies = {k: policies[k] for k in ("stacked", "stacked_slab")}
    t0 = time.time()
    sids = idx["sids"]
    age = rng.uniform(0.0, 90.0, sids.shape[0])
    fresh = sids[slot_predicates()["fresh_22"](dataclasses.replace(
        idx["catalog"], age_days=age))]
    new = TransitionMatrix.from_flat_trie(
        build_flat_trie(fresh, V, dense_d=store.dense_d), device="cuda")
    swapped = store.with_member(0, new)
    del new
    torch.cuda.synchronize()
    log(f"  re-aged fresh_22 ({fresh.shape[0]} SIDs) rebuilt and swapped into "
        f"a copy of the store in {time.time() - t0:.1f}s")
    slot_sids[0] = np.asfortranarray(fresh)
    swapped_r = {}
    for name, (policy, counter) in policies.items():
        r = GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)
        t0 = time.time()
        cold = r.set_constraints(swapped)
        torch.cuda.synchronize()
        swap_s = time.time() - t0
        if cold:
            raise AssertionError(f"{name}: set_constraints reported a cold "
                                 "swap")
        before = dict(kv.LAUNCHES)
        beams, scores = r.retrieve(hists[1], cids)
        check(f"{name} after the swap", beams, scores)
        rose = {k: kv.LAUNCHES[k] - before[k] for k in kv.LAUNCHES}
        if rose != {k: (n_sparse if k == counter else 0) for k in rose}:
            raise AssertionError(f"{name} after the swap: launches {rose}")
        log(f"  {name}: set_constraints -> cold={cold} in {swap_s:.2f}s; row "
            f"0 compliant with the new set, {counter} launched {n_sparse} "
            "times per retrieve")
        swapped_r[name] = r
    del policies
    if args.profile:
        for name, r in swapped_r.items():
            log(f"  profile of {name} (after the swap):")
            profile_retrieve(lambda: r.retrieve(hists[1], cids),
                             median_ms[name])
    return launches


def profile_retrieve(retrieve, retrieve_ms, kernel="vntk"):
    """Device time by kernel over one retrieve (torch.profiler), recorded
    after one warm-up step under the profiler (the first traced call loses
    some of its launches); the idle share is taken against the unprofiled
    median ``retrieve_ms``, and ``kernel`` names the port's kernels whose
    share and recorded launches are reported."""
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []  # the active step's events (the profiler clears them after)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            retrieve()
            torch.cuda.synchronize()
            prof.step()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    rows = [e for e in traced[0]  # kernels, not the step's GPU-side span
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
            and not e.key.startswith("ProfilerStep")]
    busy = sum(dev_us(e) for e in rows) / 1e6
    if not rows:
        log("  profile: no device time recorded (not measured)")
        return
    ours = sum(dev_us(e) for e in rows if kernel in e.key) / 1e6
    n_ours = sum(e.count for e in rows if kernel in e.key)
    log(f"  profile: device busy {busy * 1e3:.2f} ms per call; idle share "
        f"{1 - busy * 1e3 / retrieve_ms:.3f} of the unprofiled "
        f"{retrieve_ms:.2f} ms; {kernel} kernels {ours * 1e6:.1f} us in "
        f"{n_ours} launches ({ours / busy:.2e} of device time)")
    for e in sorted(rows, key=lambda e: -dev_us(e))[:15]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:150]}")


# ---------------------------------------------------------------------------
# phase 6: batch serving with a live catalog refresh
# ---------------------------------------------------------------------------
ENGINE_BURST = (8, 4, 4, 2, 2)  # (a): requests per lane, submitted at once
CHURN = 0.01  # (b): the refresh_churn scenario's churn, 200,000 of 20M items
COLD_ITEMS, COLD_SNAPSHOT = 100_000, 300_000  # (c): build, then snapshot
MIN_REFRESH_ROUNDS = 4  # (b): rounds of 5 requests served at the least


class EngineRun:
    """Serves request rounds through one engine and holds each batch to the
    path's contract: the stacked topk kernel launches ``L - dense_d`` times
    per batch and no other VNTK kernel; no request is dropped."""

    def __init__(self, eng, rng, n_sparse):
        self.eng, self.rng, self.n_sparse = eng, rng, n_sparse
        self.L = eng.retriever.L
        self.launches = 0  # stacked topk launches of every serve
        self.results = []  # every served request's result

    def serve(self, lanes):
        """Submit one request per entry of ``lanes`` (its constraint id),
        serve them all; returns (seconds, {rid: prompt}, {rid: result})."""
        from repro_torch.kernels import vntk as kv
        from repro_torch.serving import RequestQueue

        q, prompts = RequestQueue(), {}
        S = self.eng.max_len // 2
        for lane in lanes:
            p = self.rng.integers(0, self.eng.cfg.vocab_size, S)
            prompts[q.submit(p, n_tokens=self.L, constraint_id=lane)] = p
        batches = self.eng.metrics.counter("serving_batches_total").total()
        torch.cuda.synchronize()
        kv.reset_launches()  # this serve's run starts here
        t0 = time.perf_counter()
        res = self.eng.serve(q)
        dt = time.perf_counter() - t0
        rose = dict(kv.LAUNCHES)  # ... and ends here
        n = self.eng.metrics.counter("serving_batches_total").total() - batches
        want = {k: (self.n_sparse * n if k == "vntk_stacked_topk" else 0)
                for k in rose}
        if rose != want:
            raise AssertionError(f"engine: launches {rose}, expected {want} "
                                 f"over {n} batches")
        self.launches += rose["vntk_stacked_topk"]
        if len(q) or set(res) != set(prompts):
            raise AssertionError("engine: the queue did not drain")
        for rid in prompts:
            if "sids" not in res[rid]:
                raise AssertionError(f"engine: request {rid} dropped: "
                                     f"{res[rid]}")
        self.results += res.values()
        return dt, prompts, res


def check_versions(results, sets):
    """Every live beam of every result in its slot's set under the version
    in its ``store_version``; returns the count of rows per version."""
    rows = {}
    for i, r in enumerate(results):
        v = r["store_version"]
        rows[v] = rows.get(v, 0) + 1
        check_compliance(f"engine row {i} (slot {r['constraint_id']}, "
                         f"version {v})", sets[v][r["constraint_id"]],
                         r["sids"][None], r["scores"][None])
    return rows


def slot_sets(reg):
    """The registry's current slot SID sets, sorted, in Fortran order."""
    return [np.asfortranarray(reg.slot_sids(k).astype(np.int32))
            for k in range(len(reg.names))]


def phase_engine(args, params, cfg, idx):
    """(a) serving, (b) a hot delta refresh while serving, (c) a cold swap,
    (d) plain-LM generation; returns the JSON record and the stacked topk
    launches of every engine serve."""
    from repro_torch.configs import static_gr
    from repro_torch.constraints import AsyncRefresher, CatalogDelta, ItemCatalog
    from repro_torch.core.trie import sorted_unique_sids
    from repro_torch.decoding import DecodePolicy
    from repro_torch.models import transformer
    from repro_torch.observability import compile_events
    from repro_torch.serving import GenerativeRetriever, ServingEngine

    rng = np.random.default_rng([args.seed, 7])  # later phases unmoved
    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    S = static_gr.HISTORY_LEN
    reg = idx["registry"]
    store, _ = reg.current()
    B, n_sparse = store.num_sets, L - store.dense_d
    retriever = GenerativeRetriever(params, cfg, DecodePolicy.stacked(store),
                                    L, V, beam_size=M)
    eng = ServingEngine(params, cfg, batch_size=B, max_len=2 * S,
                        retriever=retriever, registry=reg)
    run = EngineRun(eng, rng, n_sparse)
    counter = eng.metrics.counter
    out = {"registry_build_s": idx["registry_build_s"]}

    # (a) a skewed burst: the first batch holds all five lanes
    c0 = compile_events()
    lanes = [lane for lane, n in enumerate(ENGINE_BURST) for _ in range(n)]
    burst_s, prompts, res = run.serve(lanes)
    rids = list(prompts)
    batches = int(counter("serving_batches_total").total())
    specialized = compile_events() - c0
    if specialized != 1:
        raise AssertionError(f"(a): {specialized} specializations, want 1")
    # round robin: the first batch holds each lane's first request
    first = [rids[lanes.index(k)] for k in range(B)]
    beams, scores = retriever.retrieve(
        np.stack([prompts[r] for r in first]).astype(np.int32),
        np.arange(B, dtype=np.int32))
    for i, rid in enumerate(first):
        got = res[rid]
        if not (np.array_equal(got["sids"], beams[i])
                and np.array_equal(got["scores"], scores[i])):
            raise AssertionError(f"(a): request {rid} differs from a direct "
                                 "retrieve of the same batch")
    sets = {1: idx["slot_sids"]}
    check_versions(run.results, sets)
    log(f"  (a) {len(lanes)} requests (lanes {ENGINE_BURST}) in {batches} "
        f"batches of {B} in {burst_s:.2f}s; first batch bit-equal to a direct "
        f"retrieve; {n_sparse} vntk_stacked_topk launches per batch, no "
        "other VNTK kernel; 100% per-row compliance")
    out["serve"] = dict(requests=len(lanes), batches=batches,
                        seconds=burst_s, first_batch_bit_equal=True,
                        launches_per_batch=n_sparse)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run.serve(range(B))
        spans = [e for e in prof.key_averages() if e.key == "serve_batch"]
        if not spans:
            raise AssertionError("no serve_batch span in the engine's trace")
        log(f"  profile: serve_batch x{spans[0].count}, "
            f"{spans[0].cpu_time_total / 1e3:.1f} ms of host time")

    # (b) 1% churn through the refresher while the engine serves
    quiet = [run.serve(range(B))[0] for _ in range(3)]
    sids = idx["sids"]
    churn = round(CHURN * sids.shape[0])
    delta = CatalogDelta(
        removed_sids=sids[rng.choice(sids.shape[0], churn, replace=False)],
        added=ItemCatalog(sids=rng.integers(0, V, (churn, L)),
                          age_days=rng.uniform(0.0, 90.0, churn),
                          category=rng.integers(0, 8, churn)))
    hot0 = counter("serving_hot_swaps_total").total()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    during, after, stale = [], [], 0.0
    with AsyncRefresher(reg) as ref:
        t0 = time.perf_counter()
        fut = ref.apply_delta_async(delta)
        while not fut.done() or len(during) < MIN_REFRESH_ROUNDS:
            during.append(run.serve(range(B))[0])
            stale = max(stale, ref.staleness_seconds())
        version = fut.result()  # a failed refresh raises here
        done_s = time.perf_counter() - t0
        apply_s = ref.metrics.histogram("refresh_apply_seconds").sum(
            kind="delta")
    peak = torch.cuda.max_memory_allocated()
    after = [run.serve(range(B))[0] for _ in range(3)]
    if version != 2:
        raise AssertionError(f"(b): refresh installed version {version}")
    hot = int(counter("serving_hot_swaps_total").total() - hot0)
    unexpected = int(counter("serving_recompiles_total").value(
        expected="false"))
    if hot != 1 or eng.cold_swaps or unexpected:
        raise AssertionError(f"(b): {hot} hot and {eng.cold_swaps} cold "
                             f"swaps, {unexpected} unexpected "
                             "specializations")
    sets[2] = slot_sets(reg)
    rows = check_versions(run.results, sets)
    split = reg.last_delta_seconds
    n_req = B * (len(during) + len(after))
    log(f"  (b) delta of {churn} removed and {churn} added items: version "
        f"{version} after {done_s:.1f}s (worker {apply_s:.1f}s: trie "
        f"assembly {split['assemble']:.1f}s, upload and stack "
        f"{split['upload']:.2f}s, flip {split['flip']:.3f}s); {n_req} "
        f"requests served meanwhile and after, none dropped, rows per "
        f"version {rows}; 1 hot swap, 0 cold, 0 unexpected "
        f"specializations; largest staleness {stale:.1f}s")
    log(f"  (b) batch latency: median {np.median(quiet) * 1e3:.1f} ms quiet, "
        f"{np.median(during) * 1e3:.1f} ms (max {max(during) * 1e3:.1f}) "
        f"over {len(during)} batches during the refresh, "
        f"{np.median(after) * 1e3:.1f} ms after; peak device memory during "
        f"the swap {peak / 1e9:.1f} GB")
    out["refresh"] = dict(
        removed=churn, added=churn, version=version, seconds=done_s,
        worker_s=apply_s, assemble_s=split["assemble"],
        upload_s=split["upload"], flip_s=split["flip"],
        max_staleness_s=stale, requests=n_req, rows_per_version=rows,
        hot_swaps=hot, cold_swaps=eng.cold_swaps,
        unexpected_specializations=unexpected,
        quiet_batch_ms=[t * 1e3 for t in quiet],
        during_batch_ms=[t * 1e3 for t in during],
        after_batch_ms=[t * 1e3 for t in after], peak_gb=peak / 1e9)
    launches = run.launches
    del eng, retriever, run, sets, delta
    del idx["registry"]  # and its version-2 store; idx["store"] is version 1
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a cold swap: a snapshot outgrows a zero-headroom envelope
    def catalog(n):
        s = sorted_unique_sids(rng.integers(0, V, (n, L)))
        return ItemCatalog(sids=s, age_days=rng.uniform(0.0, 90.0, len(s)),
                           category=rng.integers(0, 8, len(s)))

    reg2 = registry(headroom=0.0)
    store2 = reg2.build(catalog(COLD_ITEMS))
    eng2 = ServingEngine(
        params, cfg, batch_size=B, max_len=2 * S, registry=reg2,
        retriever=GenerativeRetriever(params, cfg, DecodePolicy.stacked(store2),
                                      L, V, beam_size=M))
    run2 = EngineRun(eng2, rng, n_sparse)
    run2.serve(range(B))
    sets = {1: slot_sets(reg2)}
    with AsyncRefresher(reg2) as ref:
        version = ref.swap_async(catalog(COLD_SNAPSHOT)).result()
    if version != 2 or reg2.envelope_generation != 2:
        raise AssertionError(f"(c): version {version}, envelope generation "
                             f"{reg2.envelope_generation}")
    specs = []
    for _ in range(2):
        c0 = compile_events()
        run2.serve(range(B))
        specs.append(compile_events() - c0)
    recompiles = eng2.metrics.counter("serving_recompiles_total")
    if (eng2.cold_swaps != 1 or specs != [1, 0]
            or recompiles.value(expected="true") != 2
            or recompiles.value(expected="false")):
        raise AssertionError(f"(c): {eng2.cold_swaps} cold swaps, "
                             f"specializations {specs}")
    sets[2] = slot_sets(reg2)
    rows = check_versions(run2.results, sets)
    grown = reg2.current()[0]
    log(f"  (c) {COLD_ITEMS} items at headroom 0, then a {COLD_SNAPSHOT}-item"
        f" snapshot: cold swap to {grown.n_states} states per member (was "
        f"{store2.n_states}); specializations on the next two batches "
        f"{specs}; rows per version {rows}, 100% compliant, queue drained")
    out["cold"] = dict(cold_swaps=eng2.cold_swaps, specializations=specs,
                       n_states=[store2.n_states, grown.n_states],
                       rows_per_version=rows)
    launches += run2.launches
    del eng2, run2, reg2, store2, grown

    # (d) plain-LM mode: greedy generation against a manual loop
    lm = ServingEngine(params, cfg, batch_size=2, max_len=S + 4)
    prompts = rng.integers(0, cfg.vocab_size, (2, S))
    tokens = lm.generate(prompts, 4)
    with torch.inference_mode():
        logits, cache = transformer.prefill(
            params, torch.as_tensor(prompts, device=params["emb"].device), cfg,
            max_len=S + 4)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        manual = [tok]
        for _ in range(3):
            logits, cache = transformer.decode_step(params, cache, tok, cfg)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            manual.append(tok)
        manual = torch.cat(manual, 1).cpu().numpy()
    if not np.array_equal(tokens, manual):
        raise AssertionError("(d): generate differs from prefill/decode_step")
    log(f"  (d) ServingEngine.generate, greedy, B=2, 4 tokens: equal to a "
        f"manual prefill/decode_step loop ({tokens.tolist()})")
    out["generate_equal"] = True
    out["launches"] = launches
    return out, launches


# ---------------------------------------------------------------------------
# phase 7: the paper's Table 1 baselines (§5.2) beside STATIC
# ---------------------------------------------------------------------------
TRIE_SIDS = 200_000  # the CPU trie's cut (benchmarks/table1_latency.py:133)
STEP_CALLS, STEP_REPS = 20, 7  # Phase 1-2 calls per sample, samples


def step_ms(fn, mode) -> float:
    """Median ms per call of ``fn()`` over ``STEP_REPS`` samples.

    ``graph``: ``STEP_CALLS`` calls captured in a CUDA graph, replayed
    between CUDA events (device time, no host dispatch); ``eager``: the
    calls issued from Python between CUDA events (host dispatch included
    wherever it is the longer); ``host``: a host clock around one call and
    a synchronize (the CPU trie, whose host round trip no graph holds)."""
    if mode == "graph":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(STEP_CALLS):
                fn()
        run = graph.replay
    else:
        def run():
            for _ in range(1 if mode == "host" else STEP_CALLS):
                fn()
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(STEP_REPS):
        if mode == "host":
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
            continue
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / STEP_CALLS)
    return float(np.median(samples))


def walk(policy, sids, rng, nb, L, V):
    """``nb`` catalog SIDs as prefixes, and the trie node STATIC reaches on
    each at every level (``benchmarks/table1_latency.py``'s
    ``_walk_nodes_and_prefixes``)."""
    prefixes = torch.from_numpy(
        sids[rng.integers(0, sids.shape[0], nb)].astype(np.int32)).cuda()
    rows = torch.arange(nb, device="cuda")
    nodes = [torch.ones(nb, dtype=torch.int32, device="cuda")]
    for t in range(L - 1):
        _, nxt = policy.step(torch.zeros(nb, V, device="cuda"), nodes[-1], t,
                             normalized=True)
        nodes.append(nxt[rows, prefixes[:, t].long()])
    if not all(bool((n > 0).all()) for n in nodes):
        raise AssertionError("a walked catalog SID left the trie")
    return prefixes, nodes


def baseline_policies(rng, idx):
    """The Table 1 policies over the catalog (the CPU trie over a seeded
    ``TRIE_SIDS`` subset, with a STATIC twin over the same subset)."""
    from repro_torch.configs import static_gr
    from repro_torch.core.baselines import PPVBaseline
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.decoding import DecodePolicy, PPVBackend, as_policy

    V, d = static_gr.SID_VOCAB, static_gr.DENSE_D
    sids = idx["sids"]
    t0 = time.time()
    exact = PPVBackend.from_baseline(PPVBaseline(sids, V, device="cuda"))
    ppv = {"ppv_exact": as_policy(exact),  # approx shares exact's tables
           "ppv_approx": as_policy(dataclasses.replace(exact, exact=False,
                                                       top_k=50))}
    torch.cuda.synchronize()
    log(f"  PPV table of {exact.n} SIDs ({exact.n_search_steps} search "
        f"rounds): {(exact.sids_sorted.nbytes + exact.keys.nbytes) / 1e9:.3f}"
        f" GB on the card ({time.time() - t0:.1f}s)")
    t0 = time.time()
    bitmap = DecodePolicy.hash_bitmap(sids, V, log2_bits=27, device="cuda")
    bits = bitmap.backends[0].bitmap
    ones = torch.tensor([bin(b).count("1") for b in range(256)],
                        device="cuda")
    set_share = float(ones[bits.long()].sum()) / (bits.numel() * 8)
    log(f"  hash bitmap of every prefix: 2^27 bits, {set_share:.3f} of them "
        f"set, built on the card in {time.time() - t0:.1f}s")
    t0 = time.time()
    n_cut = min(TRIE_SIDS, sids.shape[0])
    cut = sids[np.sort(rng.choice(sids.shape[0], n_cut, replace=False))]
    trie = DecodePolicy.cpu_trie(cut, V)
    tm_cut = TransitionMatrix.from_sids(cut, V, dense_d=d, device="cuda")
    log(f"  CPU trie and STATIC trie of a seeded {n_cut}-SID subset "
        f"({tm_cut.n_states} states) in {time.time() - t0:.1f}s")
    return dict(ppv, hash_bitmap=bitmap, cpu_trie=trie,
                unconstrained=DecodePolicy.unconstrained()), cut, tm_cut


def phase_table1(rng, idx, policies, cut, tm_cut):
    """Table 1 per step: each policy's Phase 1-2 call at each level over
    the same logits, with the checks of every level; returns the
    ``table1`` dict of overheads (ms, mean over levels and worst level)."""
    from repro_torch.configs import static_gr
    from repro_torch.core.vntk import NEG_INF
    from repro_torch.decoding import DecodePolicy

    V, L, M = static_gr.SID_VOCAB, static_gr.SID_LENGTH, static_gr.BEAM_SIZE
    nb = 2 * M  # B = 2 requests of M beams
    tm, store = idx["tm"], idx["store"]
    static = DecodePolicy.static(tm)
    timed = {
        "static": static,
        "static_fused": DecodePolicy.static(tm, fused=True),
        "static_dense": DecodePolicy.static(tm, topk=False),
        "stacked": DecodePolicy.stacked(store),
        **policies,
    }
    static_cut = DecodePolicy.static(tm_cut)
    prefixes, nodes = walk(static, idx["sids"], rng, nb, L, V)
    cut_prefixes, cut_nodes = walk(static_cut, cut, rng, nb, L, V)
    fresh_90 = torch.full((nb,), list(SLOTS).index("fresh_90"),
                          dtype=torch.int32, device="cuda")  # every SID
    logits = torch.from_numpy(rng.normal(size=(nb, V)).astype(
        np.float32)).cuda()
    base = {mode: step_ms(lambda: torch.log_softmax(logits, -1), mode)
            for mode in ("graph", "eager")}

    def call(name, step):
        policy = timed[name]
        on_cut = name == "cpu_trie"
        return lambda: policy.step(
            logits, (cut_nodes if on_cut else nodes)[step], step,
            prefix_tokens=(cut_prefixes if on_cut else prefixes)
            if policy.needs_prefix else None,
            constraint_ids=fresh_90 if name == "stacked" else None)

    def valid(out):
        return out[0] > NEG_INF / 2

    per_level = {name: {"graph": [], "eager": []} for name in timed}
    per_level["static_topk"] = {"graph": [], "eager": []}
    for step in range(L):
        out = {name: call(name, step)() for name in timed}
        want = valid(out["static"])
        cut_want = valid(static_cut.step(logits, cut_nodes[step], step))
        checks = {
            "ppv_exact == static": torch.equal(valid(out["ppv_exact"]), want),
            "stacked(fresh_90) == static": torch.equal(valid(out["stacked"]),
                                                       want),
            "static_fused == static": torch.equal(valid(out["static_fused"]),
                                                  want),
            "cpu_trie == static(200k)": torch.equal(valid(out["cpu_trie"]),
                                                    cut_want),
            "ppv_approx in ppv_exact": not bool(
                (valid(out["ppv_approx"]) & ~valid(out["ppv_exact"])).any()),
            "hash_bitmap contains static": not bool(
                (want & ~valid(out["hash_bitmap"])).any()),
            "unconstrained == log_softmax": torch.equal(
                out["unconstrained"][0], torch.log_softmax(logits, -1)),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"table1 level {step}: {bad}")
        for name in timed:
            host = step_ms(call(name, step), "host") if (
                name == "cpu_trie") else None
            for mode in ("graph", "eager"):
                ms = host if host is not None else step_ms(call(name, step),
                                                           mode)
                per_level[name][mode].append(ms - base[mode])
        if static.supports_topk_at(step):
            C = static.candidate_width(M, step)
            for mode in ("graph", "eager"):
                per_level["static_topk"][mode].append(step_ms(
                    lambda: static.step_topk(logits, nodes[step], step, C),
                    mode) - base[mode])
    log(f"  every level: ppv_exact and stacked(fresh_90) valid sets equal "
        f"static's, cpu_trie equals static over the {len(cut)}-SID trie, "
        "ppv_approx within ppv_exact, hash_bitmap contains static, "
        "unconstrained returns the log-softmax unchanged")
    table = {"nb": nb, "V": V, "L": L, "n_sids": int(idx["sids"].shape[0]),
             "cpu_trie_sids": len(cut),
             "log_softmax_ms": base,
             "overhead_ms": {}, "worst_level_ms": {}, "eager_overhead_ms": {},
             "levels": {}}
    for name, t in per_level.items():
        over = [max(x, 0.0) for x in t["graph"]]  # the Appendix C rule
        table["overhead_ms"][name] = float(np.mean(over))
        table["worst_level_ms"][name] = float(np.max(over))
        table["eager_overhead_ms"][name] = float(np.mean(
            [max(x, 0.0) for x in t["eager"]]))
        table["levels"][name] = [round(x, 6) for x in t["graph"]]
        log(f"  {name:14s} overhead {table['overhead_ms'][name] * 1e3:10.2f} "
            f"us (worst level {table['worst_level_ms'][name] * 1e3:10.2f}; "
            f"eager {table['eager_overhead_ms'][name] * 1e3:10.2f})")
    ref = table["overhead_ms"]["static"]
    table["ratio_to_static"] = {
        name: (table["overhead_ms"][name] / ref if ref > 0 else None)
        for name in ("cpu_trie", "ppv_exact", "ppv_approx", "hash_bitmap")}
    return table


def phase_baseline_retrieve(single, policies, idx, tm_cut, table,
                            probe_seed):
    """static-gr-3b over the catalog under each baseline, on phase 4's
    batches in turns with STATIC: PPV exact and the CPU trie must equal their STATIC twins bit
    for bit (topk and vocab-aligned plans), PPV approximate keep every live
    beam in the catalog; no VNTK kernel may launch.  The bitmap's
    false-positive probes are drawn from ``probe_seed``, not the catalog's
    seed, whose first draws are the catalog itself."""
    from repro_torch.configs import static_gr
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.launch.serve import compliance
    from repro_torch.serving import GenerativeRetriever

    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    params, cfg, hists, first = (single[k] for k in ("params", "cfg", "hists",
                                                     "first"))
    B = hists[0].shape[0]
    log(f"  {cfg.name}: {cfg.n_layers} layers, B={B}, M={M}, L={L}, phase "
        "4's batches")

    def retriever(policy):
        return GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)

    twins = {"cpu_trie": {  # STATIC over the same subset
        plan: retriever(DecodePolicy.static(tm_cut, topk=topk)).retrieve(
            hists[0]) for plan, topk in (("topk", True), ("notopk", False))},
        "ppv_exact": {"topk": first["static"], "notopk": first["static_notopk"]}}
    # in turns with STATIC over the catalog, batch by batch, so the
    # retrieve times share the card's state
    runners = {"static": retriever(DecodePolicy.static(idx["tm"]))}
    runners.update((name, retriever(p)) for name, p in policies.items())
    out, lat = {}, {name: [] for name in runners}
    for i, hist in enumerate(hists):
        for name, r in runners.items():
            kv.reset_launches()  # this retrieve's run starts here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beams, scores = r.retrieve(hist)
            if i:
                lat[name].append(time.perf_counter() - t0)
            else:
                out[name] = (beams, scores)
            launched = {k: v for k, v in kv.LAUNCHES.items() if v}  # ends
            if name != "static" and launched:
                raise AssertionError(f"{name}: a VNTK kernel launched under "
                                     f"a baseline: {launched}")
            check_batch(name, beams, scores, (B, M, L))
    median_ms = {name: float(np.median(t)) * 1e3 for name, t in lat.items()}
    for name, plans in twins.items():
        for plan, (beams, scores) in plans.items():
            if not (np.array_equal(out[name][0], beams)
                    and np.array_equal(out[name][1], scores)):
                raise AssertionError(f"{name}: SIDs or scores differ from "
                                     f"its STATIC twin ({plan})")
    # the top 50 of 2048 tokens often miss a deep prefix's few children, so
    # approximate PPV may leave no beam alive; those it keeps must be valid
    approx_in, approx_live = compliance(idx["sorted_sids"], *out["ppv_approx"])
    if approx_in != approx_live:
        raise AssertionError(f"ppv_approx: {approx_in}/{approx_live} live "
                             "beams in the catalog")
    members, live = compliance(idx["sorted_sids"], *out["hash_bitmap"])
    t0 = time.time()
    fpr = policies["hash_bitmap"].backends[0].false_positive_rate(
        idx["sids"], seed=probe_seed)
    table["retrieve_ms"] = median_ms
    table["ppv_approx_live_beams"] = approx_live
    table["hash_bitmap_compliance"] = members / max(live, 1)
    table["hash_bitmap_false_positive_rate"] = fpr
    for name, ms in median_ms.items():
        log(f"  {name} [{runners[name].policy.describe()}]: median retrieve "
            f"{ms:.2f} ms over {len(hists) - 1} batches")
    log(f"  ppv_exact and cpu_trie SIDs and scores bit-equal to their STATIC "
        f"twins (topk and vocab-aligned plans; cpu_trie against STATIC over "
        f"its {tm_cut.n_constraints}-SID subset); ppv_approx {approx_live} "
        f"of {B * M} beams live, all in the catalog; hash_bitmap "
        f"{members}/{live} live beams in the catalog, false-positive rate "
        f"{fpr:.4f} ({time.time() - t0:.1f}s); no VNTK launch under any "
        "baseline")


# ---------------------------------------------------------------------------
# phases 8-9: the EmbeddingBag kernel and the recsys path
# ---------------------------------------------------------------------------
BAG_SOURCE = "src/repro_torch/kernels/csrc/embedding_bag.cu"
BAG_REPLACES = "src/repro/kernels/embedding_bag.py:51"
# the recsys path's shapes (K = 1): (B, D, table rows) -- wide-deep's
# largest deep and wide tables at both serving batches, FM's largest table
# at serve_p99 (the only FM shape the path runs)
BAG_TIMED = ((512, 32, 10_000_000), (512, 1, 10_000_000),
             (512, 10, 1_000_000), (262_144, 32, 10_000_000),
             (262_144, 1, 10_000_000))
DLRM_LARGEST = 39_979_771  # DLRM_CRITEO_VOCABS[19]


def bf16_ulp(w):
    """One bf16 ulp at each value of the float32 tensor ``w``."""
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def agree(got, want, exact):
    """``(ok, max abs err)``: equal where ``exact``, else within rtol/atol
    1e-6 (float32) or one bf16 ulp."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if exact:
        ok = torch.equal(got, want)
    elif got.dtype == torch.float32:
        ok = torch.allclose(g, w, rtol=1e-6, atol=1e-6)
    else:
        ok = bool(((g - w).abs() <= bf16_ulp(w)).all())
    return ok and bool(torch.isfinite(g).all()), err


def compare_bag(label, table, ids, mode="sum"):
    """The kernel against its plain version; returns the max abs error.
    K = 1 must be bit-equal (a gather).  K > 1 within rtol/atol 1e-6
    (float32) or one bf16 ulp: both add in the same order, but torch on the
    card divides a mean by K as a product with 1/K, the kernel by K."""
    from repro_torch.kernels import embedding_bag as eb

    got = eb.embedding_bag_cuda(table, ids, mode)
    want = eb.embedding_bag_plain(table, ids, mode)
    torch.cuda.synchronize()
    ok, err = agree(got, want, exact=ids.shape[1] == 1)
    if not ok:
        raise AssertionError(f"embedding_bag [{label}]: differs from plain "
                             f"(max abs err {err:g})")
    return err


def compare_grouped(label, tables, ids, mode="sum", path=None):
    """The grouped launch against its plain version (the stack of per-table
    plain bags); returns the max abs error.  It must take ``path`` when
    given and launch once per 64 tables.  Sums (K = 1 among them) must be
    bit-equal, means as in :func:`compare_bag`."""
    from repro_torch.kernels import embedding_bag as eb

    took = eb.load_path(tables)
    if path is not None and took != path:
        raise AssertionError(f"embedding_bag grouped [{label}]: took the "
                             f"{took} path, expected {path}")
    n = eb.LAUNCHES["embedding_bag"]
    got = eb.embedding_bag_grouped_cuda(tables, ids, mode)
    rose = eb.LAUNCHES["embedding_bag"] - n
    if rose != -(-len(tables) // eb.MAX_TABLES):
        raise AssertionError(f"embedding_bag grouped [{label}]: {rose} "
                             f"launches for {len(tables)} tables")
    want = eb.embedding_bag_grouped_plain(tables, ids, mode)
    torch.cuda.synchronize()
    ok, err = agree(got, want, exact=mode == "sum")
    if not ok:
        raise AssertionError(f"embedding_bag grouped [{label}]: differs "
                             f"from plain (max abs err {err:g})")
    return err


def bag_bytes(table, ids) -> int:
    """Bytes the bag must move for these inputs: the ids, each distinct
    row once (at least one 32-byte sector), the output once."""
    rows = int(torch.unique(ids.clamp(0, table.shape[0] - 1)).numel())
    row = max(table.shape[1] * table.element_size(), 32)
    out = ids.shape[0] * table.shape[1] * table.element_size()
    return ids.numel() * ids.element_size() + rows * row + out


def seeded_table(gen, rows, dim, dtype=torch.float32):
    """A model-shaped table on the card: padded rows, zero from ``rows``."""
    from repro_torch.models.recsys import padded_rows

    t = torch.empty(padded_rows(rows), dim, device="cuda").normal_(
        generator=gen)
    t[rows:] = 0.0
    return t.to(dtype)


def bag_row(name, shape, path, err, ms, plain_ms, library_ms, bound,
            library):
    """One report row of the bag kernel; ``shape`` (B, F, K, D) finds its
    main-path launches (F = None: any F, for the single-table rows)."""
    return dict(name=name, route="cuda", source=BAG_SOURCE,
                replaces=BAG_REPLACES, path=path, shape=shape,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=library_ms, library=library)


def phase_bag_kernel(seed):
    """The bag kernel against its plain version (sweep, clamped ids, the
    path's shapes, grouped launches, the int64 stress) and timed at the
    path's shapes; returns one report row per timed shape (launches filled
    in later)."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as eb

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ids(B, K, hi, lo=0):
        return torch.randint(lo, hi, (B, K), generator=gen, device="cuda",
                             dtype=torch.int32)

    sweep_err = 0.0
    for B, K, D in ((8, 1, 32), (16, 4, 128), (5, 7, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.empty(201, D, device="cuda").normal_(generator=gen)
            table[200] = 0.0  # the sentinel
            table = table.to(dtype)
            for mode in ("sum", "mean"):
                sweep_err = max(sweep_err, compare_bag(
                    f"sweep {B}x{K}x{D} {dtype} {mode}", table,
                    ids(B, K, 201), mode))
    # ids out of range: negative, and past R (both clamp into [0, R])
    for D, dtype in ((10, torch.float32), (10, torch.bfloat16),
                     (1, torch.float32), (32, torch.float32)):
        table = seeded_table(gen, 200, D, dtype)
        for K, mode in ((7, "mean"), (7, "sum"), (1, "sum")):
            x = ids(1001, K, 400, lo=-200)
            sweep_err = max(sweep_err, compare_bag(
                f"clamped ids D={D} K={K} {dtype} {mode}", table, x, mode))
    log(f"  sweep and clamped ids: equal to plain within tolerance, max abs "
        f"err {sweep_err:.3g}")
    group_err = phase_bag_groups(gen, ids)
    log(f"  grouped: F = 70 (two launches), bf16 D = 32 on the v16 path, a "
        f"view 4 bytes off on the scalar path, K = 7 means of clamped ids: "
        f"equal to plain (sums bit for bit), max abs err {group_err:.3g}")

    rows_out = []
    for B, D, R in BAG_TIMED:
        table = seeded_table(gen, R, D)
        x = ids(B, 1, R)
        err = compare_bag(f"B={B} D={D} R={R}", table, x)
        ms = device_ms(lambda: eb.embedding_bag_cuda(table, x))
        plain_ms = device_ms(lambda: eb.embedding_bag_plain(table, x),
                             iters=10)
        library_ms = device_ms(lambda: F.embedding_bag(x, table, mode="sum"))
        bound = bag_bytes(table, x) / HBM_BYTES_PER_S * 1e3
        path = eb.load_path([table])
        log(f"  embedding_bag B={B} K=1 D={D} over {table.shape[0]} rows "
            f"({path}): bit-equal to plain; {ms * 1e3:.2f} us (plain "
            f"{plain_ms * 1e3:.2f} us, F.embedding_bag {library_ms * 1e3:.2f}"
            f" us, bound {bound * 1e3:.3f} us)")
        rows_out.append(bag_row(
            f"embedding_bag_b{B}_d{D}", (B, None, 1, D), path, err, ms,
            plain_ms, library_ms, bound, "F.embedding_bag"))
        del table, x
    rows_out += time_model_groups(seed, gen)
    bag_int64_stress(gen, ids)
    return rows_out


def phase_bag_groups(gen, ids):
    """Grouped launches at the shapes the model groups do not reach;
    returns the max abs error."""
    err = 0.0
    tables = [seeded_table(gen, int(r), 16) for r in
              torch.randint(20, 300, (70,), generator=gen, device="cuda")]
    x = torch.stack([ids(1001, 2, int(t.shape[0]) + 30, lo=-30)
                     for t in tables], dim=1)
    err = max(err, compare_grouped("F=70", tables, x, path="v16"))
    for mode in ("sum", "mean"):
        tables = [seeded_table(gen, 1000, 32, torch.bfloat16)
                  for _ in range(5)]
        x = torch.stack([ids(777, 4, 1000) for _ in tables], dim=1)
        err = max(err, compare_grouped(f"bf16 D=32 K=4 {mode}", tables, x,
                                       mode, path="v16"))
    base = [torch.empty(2001 * 32 + 1, device="cuda").normal_(generator=gen)
            for _ in range(3)]
    tables = [b[1:].view(2001, 32) for b in base]  # 4 bytes off
    x = torch.stack([ids(4099, 1, 2001) for _ in tables], dim=1)
    err = max(err, compare_grouped("misaligned view", tables, x,
                                   path="scalar"))
    for D, dtype, path in ((10, torch.float32, "scalar"),
                           (10, torch.bfloat16, "scalar"),
                           (32, torch.float32, "v16"),
                           (32, torch.bfloat16, "v16")):
        tables = [seeded_table(gen, 200, D, dtype) for _ in range(4)]
        for mode in ("mean", "sum"):
            x = torch.stack([ids(1001, 7, 400, lo=-200) for _ in tables],
                            dim=1)
            err = max(err, compare_grouped(
                f"clamped ids D={D} K=7 {dtype} {mode}", tables, x, mode,
                path=path))
    return err


def time_model_groups(seed, gen):
    """The grouped launches of the recsys path on wide-deep's and FM's own
    tables (seeded at their published sizes): against plain at B = 512 and
    262,144, and timed at the shapes the main path runs, beside the plain
    version and the per-table ``F.embedding_bag`` calls in one CUDA graph
    (the library yardstick).  Returns their report rows."""
    import torch.nn.functional as F

    from repro_torch.configs import fm, wide_deep
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.models import recsys

    rows_out = []
    for cfg in (wide_deep.CONFIG, fm.CONFIG):
        params = recsys.init_params(cfg, seed=seed, device="cuda")
        for kind in ("table", "wide"):
            tables = [params[f"{kind}_{i}"] for i in range(cfg.n_sparse)]
            Fn, D = len(tables), tables[0].shape[1]
            for B in (512, 262_144):
                x = torch.stack([
                    torch.randint(0, v, (B, 1), generator=gen, device="cuda",
                                  dtype=torch.int32)
                    for v in cfg.vocab_sizes], dim=1)
                label = f"{cfg.name} {kind}_i F={Fn} D={D} B={B}"
                err = compare_grouped(label, tables, x)
                if cfg is fm.CONFIG and B > 512:
                    continue  # compared only: FM serves at serve_p99
                bulk = B > 512
                ms = device_ms(lambda: eb.embedding_bag_grouped_cuda(
                    tables, x), iters=20 if bulk else 50)
                plain_ms = device_ms(lambda: eb.embedding_bag_grouped_plain(
                    tables, x), iters=3 if bulk else 10)
                cols = [x[:, f].contiguous() for f in range(Fn)]
                library_ms = device_ms(
                    lambda: [F.embedding_bag(c, t, mode="sum")
                             for c, t in zip(cols, tables)],
                    iters=3 if bulk else 10)
                bound = sum(bag_bytes(t, x[:, f]) for f, t in
                            enumerate(tables)) / HBM_BYTES_PER_S * 1e3
                size = tables[0].element_size()
                every = Fn * B * (4 + max(D * size, 32) + D * size) / (
                    HBM_BYTES_PER_S)
                path = eb.load_path(tables)
                log(f"  grouped {label} ({path}): bit-equal to plain; "
                    f"{ms * 1e3:.2f} us in one launch (plain "
                    f"{plain_ms * 1e3:.2f} us, {Fn} F.embedding_bag in a CUDA "
                    f"graph {library_ms * 1e3:.2f} us, bound "
                    f"{bound * 1e3:.3f} us; {every * 1e6:.3f} us counting "
                    "every bag's row)")
                rows_out.append(bag_row(
                    f"embedding_bag_grouped_{cfg.model}_{kind}_b{B}_f{Fn}_d{D}",
                    (B, Fn, 1, D), path, err, ms, plain_ms, library_ms, bound,
                    f"{Fn} x F.embedding_bag in one CUDA graph"))
                del x, cols
        del params, tables
        torch.cuda.empty_cache()
    return rows_out


def bag_report(bag_rows, launches):
    """The bag's report rows with their main-path ``launches`` (by (B, F,
    K, D)); a single-table row counts the launches at its (B, K, D), any F.
    Raises if a row's shape is not on the main path."""
    out = []
    for row in bag_rows:
        row = dict(row)
        B, F, K, D = row.pop("shape")
        n = sum(v for (b, f, k, d), v in launches.items()
                if (b, k, d) == (B, K, D) and F in (None, f))
        if n == 0:
            raise AssertionError(f"{row['name']}: shape not on the main path")
        out.append(dict(row, launches=n))
    return out


def bag_int64_stress(gen, ids):
    """DLRM-MLPerf's largest table (20.5 GB, freed after) read in its last
    rows, whose offsets lie past 2^31 elements, K = 1 sums and K = 4 means,
    a few ids past the end (clamped); alone, and as the second member of a
    group beside a small table."""
    t0 = time.time()
    table = seeded_table(gen, DLRM_LARGEST, 128)
    small = seeded_table(gen, 1000, 128)
    R1 = table.shape[0]
    lo = R1 - 100_000
    for K, mode in ((1, "sum"), (4, "mean")):
        compare_bag(f"int64 stress K={K} {mode}", table,
                    ids(4096, K, R1 + 50, lo=lo), mode)
        x = torch.stack([ids(4096, K, 1200, lo=-100),
                         ids(4096, K, R1 + 50, lo=lo)], dim=1)
        compare_grouped(f"int64 stress grouped K={K} {mode}", [small, table],
                        x, mode, path="v16")
    elem = lo * table.shape[1]
    log(f"  int64 stress: {R1} x {table.shape[1]} float32 "
        f"({table.numel() * 4 / 1e9:.2f} GB), rows from element {elem} "
        f"({'past' if elem >= 2 ** 31 else 'below'} 2^31) equal to plain, "
        f"alone and in a group beside a 1000-row table "
        f"({time.time() - t0:.1f}s)")
    del table, small
    torch.cuda.empty_cache()
    if elem < 2 ** 31:
        raise AssertionError("the int64 stress stays below 2^31 elements")


def sparse_batch(rng, cfg, B):
    """(B, F, K) int32 ids, uniform over each feature's table rows, on the
    card."""
    sparse = np.stack([rng.integers(0, v, size=(B, cfg.multi_hot))
                       for v in cfg.vocab_sizes], axis=1).astype(np.int32)
    return {"sparse": torch.from_numpy(sparse).cuda()}


def init_recsys(cfg, seed):
    from repro_torch.models import recsys

    t0 = time.time()
    params = recsys.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    tables = sum(t.numel() * t.element_size() for k, t in params.items()
                 if k.startswith(("table_", "wide_")))
    rows = sum(t.shape[0] for k, t in params.items() if k.startswith("table_"))
    log(f"  {cfg.name}: {cfg.n_sparse} tables x {cfg.embed_dim}, {rows} "
        f"padded rows, {tables / 1e9:.3f} GB of tables seeded on the card "
        f"in {time.time() - t0:.1f}s")
    return params


def serve_recsys(rng, params, cfg, shape, batches, per_forward):
    """One warm-up and ``batches`` timed forwards at ``shape``; each must
    launch the bag kernel ``per_forward`` times, give finite (B,) scores,
    and the first must equal its ``impl="plain"`` rerun bit for bit.
    Returns the median forward ms."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.models import recsys

    B = shape.batch
    lat = []
    for i in range(batches + 1):
        batch = sparse_batch(rng, cfg, B)
        n = eb.LAUNCHES["embedding_bag"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            scores = recsys.forward(params, batch, cfg)
        torch.cuda.synchronize()
        if i:
            lat.append(time.perf_counter() - t0)
        rose = eb.LAUNCHES["embedding_bag"] - n
        if rose != per_forward:
            raise AssertionError(f"{cfg.name} {shape.name}: {rose} bag "
                                 f"launches, expected {per_forward}")
        if scores.shape != (B,) or not torch.isfinite(scores).all():
            raise AssertionError(f"{cfg.name} {shape.name}: bad scores")
        if i == 0:
            with torch.inference_mode():
                plain = recsys.forward(params, batch, cfg, impl="plain")
            if not torch.equal(scores, plain):
                raise AssertionError(f"{cfg.name} {shape.name}: scores differ"
                                     " from impl='plain'")
    med = float(np.median(lat)) * 1e3
    log(f"  {cfg.name} {shape.name} (B={B}): median forward {med:.2f} ms over "
        f"{len(lat)} batches (ids on the card); {per_forward} bag launches "
        "per forward; finite; bit-equal to impl='plain'")
    return med


def phase_recsys(args, rng):
    """wide-deep at serve_p99 and serve_bulk, FM at serve_p99, MIND at
    retrieval_cand, all at their published sizes; returns the bag kernel's
    launches by (B, F, K, D) over that run."""
    from repro_torch.configs import RECSYS_SHAPES, fm, mind, wide_deep
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import vntk as kv
    from repro_torch.models import recsys

    shapes = {s.name: s for s in RECSYS_SHAPES}
    vntk_before = dict(kv.LAUNCHES)
    wd, fm_, mind_ = wide_deep.CONFIG, fm.CONFIG, mind.CONFIG
    params = {cfg.name: init_recsys(cfg, args.seed) for cfg in (wd, fm_, mind_)}

    # per forward, one grouped launch for the 40 (FM: 39) table_i bags and
    # one for the wide_i bags
    eb.reset_launches()  # the recsys path's run starts here
    ms = {name: serve_recsys(rng, params[wd.name], wd, shapes[name],
                             args.batches, 2)
          for name in ("serve_p99", "serve_bulk")}
    serve_recsys(rng, params[fm_.name], fm_, shapes["serve_p99"],
                 args.batches, 2)
    shape, n = shapes["retrieval_cand"], eb.LAUNCHES["embedding_bag"]
    lat = []
    for i in range(args.batches + 1):
        hist = torch.from_numpy(rng.integers(
            0, mind_.vocab_sizes[0], (shape.batch, mind_.hist_len)).astype(
                np.int32)).cuda()
        cands = torch.from_numpy(rng.integers(
            0, mind_.vocab_sizes[0], shape.n_candidates).astype(
                np.int32)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            scores = recsys.mind_retrieval_scores(params[mind_.name], hist,
                                                  cands, mind_)
        torch.cuda.synchronize()
        if i:
            lat.append(time.perf_counter() - t0)
        if (scores.shape != (shape.batch, shape.n_candidates)
                or not torch.isfinite(scores).all()):
            raise AssertionError("mind retrieval_cand: bad scores")
    if eb.LAUNCHES["embedding_bag"] != n:
        raise AssertionError("mind launched the bag kernel")
    launches = dict(eb.SHAPES)  # ... and ends here
    log(f"  {mind_.name} {shape.name} (B={shape.batch}, "
        f"{shape.n_candidates} candidates): median "
        f"{float(np.median(lat)) * 1e3:.2f} ms over {len(lat)} batches; "
        "finite; no bag launch")
    if dict(kv.LAUNCHES) != vntk_before:
        raise AssertionError("a VNTK kernel launched on the recsys path")
    if not launches:
        raise AssertionError("embedding_bag never launched on the recsys path")
    log(f"  bag launches by (B, F, K, D): {launches}")

    if args.profile:
        for name, med in ms.items():
            batch = sparse_batch(rng, wd, shapes[name].batch)
            log(f"  profile of {wd.name} {name}:")
            with torch.inference_mode():
                profile_retrieve(
                    lambda: recsys.forward(params[wd.name], batch, wd), med,
                    kernel="embedding_bag")
    del params
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import static_gr
    from repro_torch.kernels import build
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    log("phase 1: build")
    t0 = time.time()
    libs = build.build_all()
    log(f"  built {sorted(libs)} in {time.time() - t0:.1f}s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"    {line.strip()}")

    rng = np.random.default_rng(args.seed)
    log("phase 2: indexes")
    idx = build_indexes(rng, args.constraints or static_gr.N_CONSTRAINTS)

    log("phase 3: kernels vs plain versions")
    M = static_gr.BEAM_SIZE
    checks = {name: KernelCheck(name) for name in KERNELS}
    phase_kernels(rng, idx, M, [c for c in checks.values() if not c.stacked])
    latency_floor(rng, idx)
    phase_stacked_kernels(rng, idx, M,
                          [c for c in checks.values() if c.stacked],
                          full_size=args.constraints is None)
    del idx["store_slab"]  # the stacked policies build their own
    phase_golden()
    phase_attention(rng)

    cfg = static_gr.CONFIG
    t0 = time.time()
    params = transformer.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers x {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B params in {cfg.dtype} "
        f"({time.time() - t0:.1f}s init)")
    log("phase 4: single-matrix path")
    launches, single = phase_single(args, rng, params, cfg, idx)
    log("phase 5: stacked path")
    stacked = phase_stacked(args, rng, params, cfg, idx)
    launches.update({k: v for k, v in stacked.items() if "stacked" in k})
    gc.collect()  # phase 5's retrievers and slabs
    torch.cuda.empty_cache()
    log("phase 6: batch serving with a live catalog refresh")
    t0 = time.time()
    engine, engine_launches = phase_engine(args, params, cfg, idx)
    launches["vntk_stacked_topk"] += engine_launches
    engine["seconds"] = time.time() - t0
    print(json.dumps({"engine": engine}), flush=True)
    log(f"  phase 6 took {engine['seconds']:.1f}s")
    log("phase 7: Table 1 baselines beside STATIC")
    t0 = time.time()
    table_rng = np.random.default_rng([args.seed, 6])  # later phases unmoved
    policies, cut, tm_cut = baseline_policies(table_rng, idx)
    table1 = phase_table1(table_rng, idx, policies, cut, tm_cut)
    phase_baseline_retrieve(single, policies, idx, tm_cut, table1,
                            probe_seed=args.seed + 1)
    table1["seconds"] = time.time() - t0
    print(json.dumps({"table1": table1}), flush=True)
    log(f"  phase 7 took {table1['seconds']:.1f}s")
    peaks = [torch.cuda.max_memory_allocated()]  # phases 1-7
    del idx, params, single, policies, tm_cut
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 8: embedding bag kernel vs plain version (retrieval state "
        f"released: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    torch.cuda.reset_peak_memory_stats()
    bag_rows = phase_bag_kernel(args.seed)
    peaks.append(torch.cuda.max_memory_allocated())
    log(f"  phase 8 peak device memory {peaks[-1] / 1e9:.1f} GB")
    log("phase 9: recsys path")
    torch.cuda.reset_peak_memory_stats()
    bag_launches = phase_recsys(args, rng)
    peaks.append(torch.cuda.max_memory_allocated())
    log(f"  phase 9 peak device memory {peaks[-1] / 1e9:.1f} GB")

    peak = max(peaks)
    log(f"phase 10: report ({time.time() - t_start:.1f}s total; peak device "
        f"memory {peak / 1e9:.1f} GB)")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    rows = []
    for chk in checks.values():  # no PyTorch call computes the VNTK step
        ms, plain_ms, bound = np.mean(chk.times, axis=0)
        rows.append(dict(
            name=chk.name, route="cuda", source=VNTK_SOURCE,
            replaces=chk.replaces, launches=launches[chk.name],
            max_abs_err=chk.max_abs_err, ms=float(ms),
            plain_ms=float(plain_ms), bound_ms=float(bound), bound_by="bytes",
            library_ms=None, path=chk.main_path()))
    rows += bag_report(bag_rows, bag_launches)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
