"""STATIC memory-usage model (paper Appendix B) + decode-step traffic model.

Counterpart of ``repro.core.memory_model``, reading the port's torch
tensors (numpy arrays work too).  The candidate width uses the port's lane
(:func:`repro_torch.core.vntk.topk_lane`), so ``decode_step_traffic`` has
no ``impl`` argument.

``u_max`` is the closed-form upper bound

    U_max = (1/8 + K2) |V|^d  +  K1 * sum_{l=d+1..L} min(|V|^l, |C|)

and ``capacity_rule_of_thumb`` is the §B.3 planning rule ("~90 MB per 1M
constraints" at the paper's V=2048, L=8, d=2 setting), evaluated as
``u_max`` at the requested catalog size directly: the dense term
``(1/8+K2)|V|^d`` does not scale with |C|, so the old
``u_max(1M) * |C|/1M`` extrapolation overcounted it 10x at 10M SIDs and
buried the true per-item cost at 10k.  ``measure`` reports the *actual*
bytes of a built TransitionMatrix (or any trie-like object exposing the
same fields) so tests can assert actual <= U_max (the paper observes
<=75% utilization in production due to prefix clustering).

``decode_step_traffic`` models the per-step HBM bytes the constraint stage
moves on the two decode paths (DESIGN.md §8): the dense path writes two full
vocab-aligned ``(B*M, V)`` tensors (masked log-probs + next-state map) and
re-reads them for the ``M*V`` top-k; the candidate-compressed path writes
three ``(B*M, C)`` tensors with ``C = min(round_up(M, lane), V)`` — constant
in ``V``, which is what flattens the fig3 vocab-scaling curves.

Large-catalog extensions (DESIGN.md §11): ``k1_compressed`` /
``u_max_compressed`` model the delta-encoded slab (per-node bytes drop from
12 to 4 + tok, tok = 2 where the vocab fits int16 deltas — the next-state
array vanishes entirely because destinations are consecutive per level),
and ``plan_tiers`` models an HBM/host split at a level boundary with the
per-step prefetch staging cost.
"""
from __future__ import annotations

import torch

from repro_torch.core.vntk import candidate_width, topk_lane

__all__ = ["u_max", "capacity_rule_of_thumb", "measure", "decode_step_traffic",
           "k1_compressed", "u_max_compressed", "plan_tiers",
           "K1_DEFAULT", "K2_DEFAULT"]

# K1: bytes per CSR trie node. The paper counts 12 B for the three CSR arrays
# (4 B row-pointer + 4 B column index + 4 B value); our stacked layout stores
# the same 12 B per edge-bearing node.
K1_DEFAULT = 12
# K2: bytes per dense state id (int32).
K2_DEFAULT = 4


def u_max(
    vocab_size: int,
    n_constraints: int,
    sid_length: int,
    dense_d: int = 2,
    k1: int = K1_DEFAULT,
    k2: int = K2_DEFAULT,
) -> int:
    """Upper bound on HBM bytes for the STATIC structures (Appendix B.1)."""
    dense = (0.125 + k2) * (vocab_size ** dense_d) if dense_d > 0 else 0.0
    sparse = 0
    for level in range(dense_d + 1, sid_length + 1):
        cap = min(vocab_size ** level, n_constraints)
        sparse += cap
    return int(dense + k1 * sparse)


def capacity_rule_of_thumb(
    n_constraints: int,
    vocab_size: int = 2048,
    sid_length: int = 8,
    dense_d: int = 2,
) -> float:
    """Planning estimate in bytes (the §B.3 rule, ~90 MB at 1M items).

    Evaluates the closed form at ``n_constraints`` directly.  The dense
    ``(1/8+K2)|V|^d`` term is a fixed cost independent of catalog size;
    only the sparse ``K1 * sum min(|V|^l, |C|)`` levels scale with |C|.
    """
    return float(u_max(vocab_size, n_constraints, sid_length, dense_d))


def k1_compressed(vocab_size: int) -> int:
    """Per-node bytes of the delta-encoded slab (DESIGN.md §11).

    4 B row pointer + the edge token delta (2 B when every delta fits
    int16, i.e. ``vocab_size <= 32768``, else 4 B).  No next-state bytes:
    destination states are consecutive over each level's edge block, so
    ``next = edge_index + level_base[level]`` with an O(L) base table.
    """
    return 4 + (2 if vocab_size <= 32768 else 4)


def u_max_compressed(
    vocab_size: int,
    n_constraints: int,
    sid_length: int,
    dense_d: int = 2,
    k2: int = K2_DEFAULT,
) -> int:
    """``u_max`` under the compressed-slab encoding (same dense term)."""
    return u_max(vocab_size, n_constraints, sid_length, dense_d,
                 k1=k1_compressed(vocab_size), k2=k2)


def decode_step_traffic(
    vocab_size: int,
    batch: int,
    beams: int,
    *,
    width: int | None = None,
    lane: int | None = None,
    lp_bytes: int = 4,
    idx_bytes: int = 4,
) -> dict:
    """Per-step HBM bytes moved by the constraint stage on both paths.

    Write traffic only (the logits read is common to both paths and the
    fused kernels overlap it with the model's own output write):

      * dense:     ``B*M * V * (lp + idx)``   — masked log-probs + the
                    vocab-aligned next-state map, then re-read by the
                    ``M*V``-lane host top-k (counted once more as reads);
      * candidate: ``B*M * C * (lp + 2*idx)`` — scores, tokens and next
                    states of the per-beam top-C lists; the top-M re-reads
                    ``M*C`` lanes.

    ``width=None`` derives ``C`` from :func:`~repro_torch.core.vntk.
    candidate_width` at the port's lane (:func:`~repro_torch.core.vntk.
    topk_lane`); pass ``lane=`` to override.  Returns both totals plus
    their ratio — the model the DESIGN.md §8 table quotes.
    """
    nb = batch * beams
    if lane is None:
        lane = topk_lane()
    C = candidate_width(beams, vocab_size, lane=lane) if width is None else width
    dense_write = nb * vocab_size * (lp_bytes + idx_bytes)
    dense_select_read = nb * vocab_size * lp_bytes
    cand_write = nb * C * (lp_bytes + 2 * idx_bytes)
    cand_select_read = nb * C * lp_bytes
    dense_total = dense_write + dense_select_read
    cand_total = cand_write + cand_select_read
    return dict(
        width=int(C),
        lane=int(lane),
        dense_write_bytes=int(dense_write),
        dense_total_bytes=int(dense_total),
        candidate_write_bytes=int(cand_write),
        candidate_total_bytes=int(cand_total),
        compression_ratio=float(dense_total / max(cand_total, 1)),
    )


def _nbytes(arr) -> int:
    """Bytes of a tensor (or numpy array); 0 for absent (None) tables."""
    if arr is None:
        return 0
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(arr.size) * int(arr.dtype.itemsize)


def measure(tm, slab=None) -> dict:
    """Actual byte usage of a built trie, split by component.

    ``tm`` is any object with ``row_pointers``/``edges`` plus the usual
    scalar metadata — a :class:`TransitionMatrix`, a ``FlatTrie``, or a
    duck-typed equivalent.  Dense-level tables are discovered by probing
    ``l{i}_mask_packed`` / ``l{i}_states`` for every ``i``; absent (None)
    tables — e.g. a ``dense_d=0`` trie, the continuous engine's default —
    count zero bytes instead of crashing, and deeper dense bands are
    summed without code changes.

    ``slab`` (optional): a compressed slab for the same trie (DESIGN.md
    §11).  When given, ``compressed_bytes`` reports the bytes of the
    compressed representation (row pointers + delta tokens + level bases,
    replacing ``edges``) and ``compression_ratio`` its win over the
    uncompressed slab.
    """
    dense_bytes = 0
    i = 0
    while hasattr(tm, f"l{i}_mask_packed") or hasattr(tm, f"l{i}_states"):
        dense_bytes += _nbytes(getattr(tm, f"l{i}_mask_packed", None))
        dense_bytes += _nbytes(getattr(tm, f"l{i}_states", None))
        i += 1
    sparse_bytes = _nbytes(tm.row_pointers) + _nbytes(tm.edges)
    bound = u_max(tm.vocab_size, tm.n_constraints, tm.sid_length, tm.dense_d)
    out = dict(
        dense_bytes=int(dense_bytes),
        sparse_bytes=int(sparse_bytes),
        total_bytes=int(dense_bytes + sparse_bytes),
        u_max_bytes=int(bound),
        utilization=float((dense_bytes + sparse_bytes) / max(bound, 1)),
    )
    if slab is not None:
        comp = (_nbytes(tm.row_pointers) + _nbytes(slab.tok_delta)
                + _nbytes(slab.level_base))
        out["compressed_bytes"] = int(comp)
        out["compressed_total_bytes"] = int(dense_bytes + comp)
        out["compression_ratio"] = float(sparse_bytes / max(comp, 1))
    return out


def plan_tiers(
    vocab_size: int,
    n_constraints: int,
    sid_length: int,
    dense_d: int = 2,
    *,
    hot_levels: int | None = None,
    batch: int = 1,
    beams: int = 10,
    bmax: int | None = None,
    compressed: bool = False,
    hbm_budget: int | None = None,
    k2: int = K2_DEFAULT,
) -> dict:
    """Model an HBM/host tier split of the sparse levels (DESIGN.md §11).

    Levels ``< hot_levels`` (plus the dense band) stay HBM-resident; levels
    ``>= hot_levels`` live in host memory and are prefetched per step as a
    ``(B*M, bmax)`` staged slab driven by the surviving beam nodes.  With
    ``hot_levels=None`` and an ``hbm_budget``, picks the deepest split
    whose hot bytes fit the budget (falling back to the dense band + level
    ``dense_d`` alone); with neither, everything is hot.

    Returns per-level node capacities and the modeled ``hbm_bytes`` /
    ``host_bytes`` / ``prefetch_bytes_per_step`` — finite for any catalog
    size, which is the whole point: a 100M-SID trie that cannot fit HBM
    still has a concrete, finite serving plan.
    """
    k1 = k1_compressed(vocab_size) if compressed else K1_DEFAULT
    dense = int((0.125 + k2) * (vocab_size ** dense_d)) if dense_d > 0 else 0
    # per-level node capacity, levels dense_d+1 .. L (paper Appendix B)
    caps = {lvl: min(vocab_size ** lvl, n_constraints)
            for lvl in range(dense_d + 1, sid_length + 1)}
    level_bytes = {lvl: k1 * cap for lvl, cap in caps.items()}
    levels = sorted(level_bytes)
    if hot_levels is None:
        if hbm_budget is None:
            hot_levels = sid_length
        else:
            hot_levels = dense_d
            acc = dense
            for lvl in levels:
                if acc + level_bytes[lvl] > hbm_budget:
                    break
                acc += level_bytes[lvl]
                hot_levels = lvl
    hot_levels = max(dense_d, min(int(hot_levels), sid_length))
    hot_sparse = sum(b for lvl, b in level_bytes.items() if lvl <= hot_levels)
    cold = sum(b for lvl, b in level_bytes.items() if lvl > hot_levels)
    # staged slab: one speculative (token, next) burst per live beam; the
    # prefetcher stages at most B*M rows of bmax edges per cold step
    if bmax is None:
        bmax = min(vocab_size, 128)
    edge_entry = 2 if compressed and vocab_size <= 32768 else 8
    staging = batch * beams * bmax * (8 if not compressed else edge_entry + 4)
    return dict(
        hot_levels=int(hot_levels),
        dense_bytes=int(dense),
        level_bytes={int(k): int(v) for k, v in level_bytes.items()},
        hbm_bytes=int(dense + hot_sparse + staging),
        host_bytes=int(cold),
        prefetch_bytes_per_step=int(staging if cold else 0),
        total_bytes=int(dense + hot_sparse + cold),
        compressed=bool(compressed),
    )
