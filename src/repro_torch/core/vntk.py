"""Vectorized Node Transition Kernel — plain PyTorch references (paper Alg. 2).

The counterparts of ``repro.core.vntk``'s XLA references, and the oracles of
the CUDA kernels in ``repro_torch.kernels.vntk``.  Torch has no fill-mode
gather and no implicit index clamping, so the speculative burst masks its
out-of-range slots explicitly and the projection scatters into a
``(nb, V + 1)`` buffer whose extra column absorbs invalid slots, as the
reference does.  The compressed-slab references (DESIGN.md §11) decode a
burst of token deltas and share the projection and the selection.  Integer
outputs leave as int32, like the reference's.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "LANE", "topk_lane", "candidate_width", "top_m",
           "vntk_reference_scatter", "vntk_topk_reference",
           "vntk_stacked_reference_scatter", "vntk_stacked_topk_reference",
           "vntk_compressed_reference", "vntk_stacked_compressed_reference",
           "vntk_compressed_topk_reference",
           "vntk_stacked_compressed_topk_reference"]

NEG_INF = -1.0e10

# Candidate-width lane rounding (DESIGN.md §8).  The TPU kernel rounded C to
# its 128-wide lane; the port keeps the reference's layout-free XLA lane.
# Bit-identity only needs C >= min(M, V).
LANE = 8


def topk_lane() -> int:
    """Lane the candidate-topk output width is rounded to."""
    return LANE


def candidate_width(beams: int, vocab_size: int, lane: int = LANE) -> int:
    """Per-beam candidate count ``C = min(round_up(M, lane), V)`` (§8)."""
    return max(1, min(-(-int(beams) // lane) * lane, int(vocab_size)))


def top_m(x: torch.Tensor, m: int):
    """Top ``m`` along the last axis, ties to the lower index (lax.top_k).

    ``torch.topk`` promises no tie order, so this is a stable descending
    sort; beam search and the MoE router both select through it.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :m], idx[..., :m]


def _rows(nodes, row_pointers, constraint_ids=None):
    """Phase 1: ``(starts, lens, cid)`` of each row's CSR row (int64).

    With ``constraint_ids`` the tables carry a leading constraint axis and
    row ``r`` reads member ``constraint_ids[r]``, clamped into ``[0, K)`` as
    the reference's gather clamps it; ``cid`` is ``None`` otherwise.
    """
    n = nodes.reshape(-1).long()
    if constraint_ids is None:
        starts = row_pointers[n].long()  # index first: the trie has ~1e8 rows
        return starts, row_pointers[n + 1].long() - starts, None
    cid = constraint_ids.expand(nodes.shape).reshape(-1).long().clamp(
        0, row_pointers.shape[0] - 1)
    starts = row_pointers[cid, n].long()
    return starts, row_pointers[cid, n + 1].long() - starts, cid


def _speculative_burst(nodes, row_pointers, edges, bmax: int,
                       constraint_ids=None):
    """Phases 1-3: row lookup, ``bmax``-slot burst, ``iota < n_child``.

    With ``constraint_ids`` the tables are ``(K, S+1)`` / ``(K, E, 2)``
    (see :func:`_rows`).  Returns ``(cols, nxt, valid)``, each
    ``(nb, bmax)``; ``cols`` is int64 (torch indexes with it), ``nxt`` int32
    and 0 on invalid slots.  Slots past the edge array read 0, like the
    reference's ``mode="fill"`` take: only in-bounds slots are read.
    """
    starts, lens, cid = _rows(nodes, row_pointers, constraint_ids)
    E = edges.shape[-2]
    offsets = torch.arange(bmax, device=nodes.device)
    idx = starts[:, None] + offsets[None, :]
    in_range = (idx >= 0) & (idx < E)
    idx = idx.clamp(0, E - 1)
    gathered = edges[idx] if cid is None else edges[cid[:, None], idx]
    gathered = torch.where(in_range[..., None], gathered, 0)
    valid = offsets[None, :] < lens[:, None]
    cols = gathered[..., 0].long()
    nxt = torch.where(valid, gathered[..., 1], 0).to(torch.int32)
    return cols, nxt, valid


def _expand_delta_slots(tok_delta, starts, lens, bmax: int, base, cid=None):
    """Phases 2-3 over a delta slab: ``(cols, nxt, valid)`` as
    :func:`_speculative_burst` returns them.

    A burst starts at a row start, whose delta is the absolute token, so an
    int32 prefix sum along the slots gives the tokens (the cast comes before
    the sum: int16 partial sums would wrap); the next state of edge ``e`` is
    ``e + base``.  ``base`` is a scalar or one value per row.  Slots past a
    row's end decode to garbage, as the uncompressed over-read does, and
    ``valid`` masks both; slots past the slab read 0.
    """
    offsets = torch.arange(bmax, device=starts.device)
    idx = starts[:, None] + offsets[None, :]
    E = tok_delta.shape[-1]
    in_range = (idx >= 0) & (idx < E)
    idx_c = idx.clamp(0, E - 1)
    deltas = tok_delta[idx_c] if cid is None else tok_delta[cid[:, None], idx_c]
    deltas = torch.where(in_range, deltas.to(torch.int32), 0)
    cols = torch.cumsum(deltas, dim=1, dtype=torch.int64)
    valid = offsets[None, :] < lens[:, None]
    base = torch.as_tensor(base, device=starts.device).long()
    base = base.reshape(-1, 1) if base.dim() else base
    nxt = torch.where(valid, idx + base, 0).to(torch.int32)
    return cols, nxt, valid


def _compressed_burst(nodes, row_pointers, tok_delta, base, bmax: int,
                      constraint_ids=None):
    """Phases 1-3 over a compressed slab; stacked, row ``r`` takes
    ``base[cid[r]]`` of the ``(K,)`` per-member bases, else ``base`` is a
    scalar or one value per row (broadcast like ``nodes``)."""
    starts, lens, cid = _rows(nodes, row_pointers, constraint_ids)
    base = torch.as_tensor(base, device=starts.device)
    if cid is not None:
        base = base[cid]
    elif base.dim():
        base = base.expand(nodes.shape).reshape(-1)
    return _expand_delta_slots(tok_delta, starts, lens, bmax, base, cid)


def _project_scatter(log_probs, nodes, burst, vocab_size: int):
    """Phase 4, vocab-aligned: scatter the valid slots into a ``(nb, V+1)``
    buffer whose extra column absorbs the invalid ones."""
    V = vocab_size
    batch_shape = tuple(nodes.shape)
    lp = log_probs.reshape(-1, V)
    nb = lp.shape[0]
    cols, nxt, valid = burst
    scatter_idx = torch.where(valid, cols, V)
    cand_lp = lp.gather(1, cols.clamp(0, V - 1))
    masked = lp.new_full((nb, V + 1), NEG_INF)
    masked.scatter_(1, scatter_idx, torch.where(valid, cand_lp, NEG_INF))
    next_dense = nxt.new_zeros((nb, V + 1))
    next_dense.scatter_(1, scatter_idx, nxt)
    return (masked[:, :V].reshape(batch_shape + (V,)),
            next_dense[:, :V].reshape(batch_shape + (V,)))


def vntk_reference_scatter(log_probs, nodes, row_pointers, edges,
                           bmax: int, vocab_size: int):
    """Alg. 2, vocab-aligned: ``(masked_log_probs, next_dense)``, both
    ``(..., V)``; ``NEG_INF`` / 0 off the trie."""
    return _project_scatter(
        log_probs, nodes,
        _speculative_burst(nodes, row_pointers, edges, bmax), vocab_size)


def vntk_stacked_reference_scatter(log_probs, nodes, constraint_ids,
                                   row_pointers, edges, bmax: int,
                                   vocab_size: int):
    """Stacked-store Alg. 2: as :func:`vntk_reference_scatter`, row ``r``
    masked by member ``constraint_ids[r]`` of the ``(K, S+1)`` /
    ``(K, E, 2)`` tables."""
    return _project_scatter(
        log_probs, nodes,
        _speculative_burst(nodes, row_pointers, edges, bmax, constraint_ids),
        vocab_size)


def _topk_from_candidates(lp_flat, cols, nxt, valid, width: int,
                          vocab_size: int):
    """Per-beam dense-rank top-``width`` without the dense row (§8).

    Valid children rank by (lp desc, token asc); the ``width`` smallest
    missing tokens follow at ``NEG_INF`` (the i-th missing token of sorted
    distinct columns is ``i + |{j : cols[j] - j <= i}|``).  Slots that do not
    exist sink to the float minimum.  The stable descending sort keeps the
    lower index first among equal keys — ``jax.lax.top_k``'s order, on which
    bit-identity with the dense path rests.
    """
    nb, bmax = cols.shape
    V = vocab_size
    dev = lp_flat.device
    minf = torch.finfo(torch.float32).min
    offsets = torch.arange(bmax, device=dev)

    cand_lp = lp_flat.gather(1, cols.clamp(0, V - 1))
    real_key = torch.where(valid, cand_lp, minf)
    real_tok = torch.where(valid, cols, 0)

    adj = torch.where(valid, cols - offsets[None, :], V + bmax + 1)
    fill_i = torch.arange(width, device=dev)
    cnt = (adj[:, None, :] <= fill_i[None, :, None]).sum(-1)
    fill_tok = fill_i[None, :] + cnt
    in_range = fill_tok < V
    fill_key = torch.where(in_range, NEG_INF, minf).to(lp_flat.dtype)
    fill_tok = torch.where(in_range, fill_tok, 0)

    keys = torch.cat([real_key, fill_key], dim=1)
    toks = torch.cat([real_tok, fill_tok], dim=1).to(torch.int32)
    nexts = torch.cat(
        [nxt, torch.zeros((nb, width), dtype=torch.int32, device=dev)], dim=1)

    top_vals, top_idx = torch.sort(keys, dim=1, descending=True, stable=True)
    top_idx = top_idx[:, :width]
    return (top_vals[:, :width], toks.gather(1, top_idx),
            nexts.gather(1, top_idx))


def _topk(log_probs, nodes, burst, vocab_size: int, width: int):
    V = vocab_size
    batch_shape = tuple(nodes.shape)
    sc, tok, nx = _topk_from_candidates(log_probs.reshape(-1, V), *burst,
                                        width, V)
    shp = batch_shape + (width,)
    return sc.reshape(shp), tok.reshape(shp), nx.reshape(shp)


def vntk_topk_reference(log_probs, nodes, row_pointers, edges, bmax: int,
                        vocab_size: int, width: int):
    """Candidate-compressed Alg. 2: ``(scores, tokens, next_states)``, each
    ``(..., width)`` — the per-beam dense-rank top-``width``."""
    return _topk(log_probs, nodes,
                 _speculative_burst(nodes, row_pointers, edges, bmax),
                 vocab_size, width)


def vntk_stacked_topk_reference(log_probs, nodes, constraint_ids,
                                row_pointers, edges, bmax: int,
                                vocab_size: int, width: int):
    """Stacked-store candidate-compressed step: one extra constraint-axis
    gather through Phases 1-3, the same selection."""
    return _topk(log_probs, nodes,
                 _speculative_burst(nodes, row_pointers, edges, bmax,
                                    constraint_ids),
                 vocab_size, width)


def vntk_compressed_reference(log_probs, nodes, row_pointers, tok_delta, base,
                              bmax: int, vocab_size: int):
    """Alg. 2 over the compressed slab (DESIGN.md §11): ``tok_delta``
    ``(E+pad,)`` int16/int32 deltas, ``base`` the step's next-state base.
    Equal to :func:`vntk_reference_scatter` on the same trie."""
    return _project_scatter(
        log_probs, nodes,
        _compressed_burst(nodes, row_pointers, tok_delta, base, bmax),
        vocab_size)


def vntk_stacked_compressed_reference(log_probs, nodes, constraint_ids,
                                      row_pointers, tok_delta, base_k,
                                      bmax: int, vocab_size: int):
    """Stacked compressed Alg. 2: ``(K, S+1)`` row pointers, ``(K, E+pad)``
    deltas and the ``(K,)`` per-member bases of the step."""
    return _project_scatter(
        log_probs, nodes,
        _compressed_burst(nodes, row_pointers, tok_delta, base_k, bmax,
                          constraint_ids),
        vocab_size)


def vntk_compressed_topk_reference(log_probs, nodes, row_pointers, tok_delta,
                                   base, bmax: int, vocab_size: int,
                                   width: int):
    """Candidate-compressed step over the compressed slab: equal to
    :func:`vntk_topk_reference` on the same trie."""
    return _topk(log_probs, nodes,
                 _compressed_burst(nodes, row_pointers, tok_delta, base, bmax),
                 vocab_size, width)


def vntk_stacked_compressed_topk_reference(log_probs, nodes, constraint_ids,
                                           row_pointers, tok_delta, base_k,
                                           bmax: int, vocab_size: int,
                                           width: int):
    """Stacked compressed candidate-topk (the K-store twin)."""
    return _topk(log_probs, nodes,
                 _compressed_burst(nodes, row_pointers, tok_delta, base_k,
                                   bmax, constraint_ids),
                 vocab_size, width)
