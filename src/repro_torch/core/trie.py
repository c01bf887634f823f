"""Offline trie construction and CSR flattening (paper §4.2).

A numpy copy of ``repro.core.trie``'s builder, array for array: a single
lexicographic sort of the restricted vocabulary followed by per-level
prefix-change scans, never a pointer-based trie.  :func:`infer_level_blocks`
checks a built slab's canonical layout in torch, on the tensors' own device.

State-id convention (paper Figure 1):
  * state 0            -- the sink: no outgoing transitions.
  * state 1            -- the root (the empty prefix).
  * states at level l  -- contiguous id range [level_offsets[l], level_offsets[l+1]).

``edges`` is the stacked ``(n_edges + pad, 2)`` layout of paper §A.1.1,
interleaving ``(token, next_state)``.  The tail pad of ``max(bmax)`` rows
keeps a speculative burst of ``bmax`` slots starting at any row start in
bounds; the CUDA kernels have no fill-mode gather and rely on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FlatTrie", "build_flat_trie", "pack_bits", "unpack_bits_word",
           "sorted_unique_sids", "check_index_capacity", "LevelBlocks",
           "infer_level_blocks", "random_constraint_set"]


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a boolean array into little-endian uint8 words along the last axis.

    Bit ``i`` of word ``w`` is element ``8*w + i`` (np.packbits is
    big-endian; the unpack on the device is then a plain shift-and-mask).
    """
    bits = np.asarray(bits, dtype=bool)
    pad = (-bits.shape[-1]) % 8
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), bool)], axis=-1
        )
    b = bits.reshape(bits.shape[:-1] + (-1, 8)).astype(np.uint8)
    weights = (1 << np.arange(8, dtype=np.uint8)).reshape((1,) * (b.ndim - 1) + (8,))
    return (b * weights).sum(axis=-1).astype(np.uint8)


def unpack_bits_word(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`: the first ``n`` bits of each row."""
    bits = (packed[..., :, None] >> np.arange(8, dtype=np.uint8)) & 1
    bits = bits.reshape(packed.shape[:-1] + (-1,))
    return bits[..., :n].astype(bool)


@dataclasses.dataclass
class FlatTrie:
    """CSR-flattened prefix tree over a restricted Semantic-ID vocabulary."""

    vocab_size: int
    sid_length: int
    n_constraints: int
    row_pointers: np.ndarray  # (n_states + 1,) int32|int64
    edges: np.ndarray  # (n_edges + pad, 2): [token, next_state]
    n_states: int
    n_edges: int
    level_offsets: np.ndarray  # (L + 2,) first state id of each level
    level_bmax: np.ndarray  # (L,) max branch factor consulted at step l
    dense_d: int
    l0_mask_packed: np.ndarray | None = None  # (ceil(V/8),) uint8
    l0_states: np.ndarray | None = None  # (V,) CSR id of level-1 node (0=sink)
    l1_mask_packed: np.ndarray | None = None  # (V, ceil(V/8)) uint8
    l1_states: np.ndarray | None = None  # (V, V) CSR id of level-2 node


def _validate_sids(sids: np.ndarray, vocab_size: int) -> np.ndarray:
    sids = np.asarray(sids)
    if sids.ndim != 2:
        raise ValueError(f"sids must be (N, L), got shape {sids.shape}")
    if sids.size == 0:
        raise ValueError("constraint set must be non-empty")
    if sids.min() < 0 or sids.max() >= vocab_size:
        raise ValueError("token ids out of range [0, vocab_size)")
    return sids.astype(np.int64, copy=False)


def sorted_unique_sids(sids: np.ndarray) -> np.ndarray:
    """Lexicographically sorted, deduplicated SID rows.

    Rows that are already strictly ascending (a subset of a sorted catalog,
    say) come back as they are, without the sort.
    """
    n, L = sids.shape
    if n > 1:
        diff = sids[1:] != sids[:-1]
        first = diff.argmax(axis=1)  # first differing column per row pair
        rows = np.arange(n - 1)
        if (diff[rows, first] & (sids[1:][rows, first]
                                 > sids[:-1][rows, first])).all():
            return sids
    order = np.lexsort(tuple(sids[:, c] for c in range(L - 1, -1, -1)))
    s = sids[order]
    if n > 1:
        dup = np.all(s[1:] == s[:-1], axis=1)
        if dup.any():
            s = s[np.concatenate([[True], ~dup])]
    return s


def check_index_capacity(index_dtype, *, n_states: int, n_edge_rows: int,
                         vocab_size: int) -> None:
    """Raise unless every CSR index value fits ``index_dtype``.

    ``row_pointers`` reach ``n_edges`` (plus the speculative pad, hence
    ``n_edge_rows``), ``edges[:, 1]`` reaches ``n_states - 1`` and the
    virtual l0 ids reach ``vocab_size``.
    """
    limit = np.iinfo(np.dtype(index_dtype)).max
    worst = max(int(n_states), int(n_edge_rows), int(vocab_size))
    if worst > limit:
        raise ValueError(
            f"index_dtype={np.dtype(index_dtype).name} cannot address "
            f"{worst} (n_states={n_states}, padded edge rows={n_edge_rows}, "
            f"vocab_size={vocab_size}); build with index_dtype=np.int64"
        )


def build_flat_trie(
    sids: np.ndarray,
    vocab_size: int,
    dense_d: int = 2,
    index_dtype=np.int32,
) -> FlatTrie:
    """Flatten the prefix tree of ``sids`` into a stacked-CSR transition matrix.

    Args:
      sids: (N, L) integer array of Semantic IDs (the restricted vocabulary C).
      vocab_size: token cardinality |V| (shared across levels).
      dense_d: how many leading levels get dense bit-packed masks (0, 1 or 2).
      index_dtype: dtype of CSR indices (int32 is enough below ~2e9 states).
    """
    if dense_d not in (0, 1, 2):
        raise ValueError("dense_d must be 0, 1, or 2 (paper: d<=2 in practice)")
    sids = _validate_sids(sids, vocab_size)
    n, L = sids.shape
    s = sorted_unique_sids(sids)
    n = s.shape[0]

    # new_prefix[i, l] == True iff row i starts a new unique (l+1)-prefix.
    if n > 1:
        diff = s[1:] != s[:-1]
        changed = np.logical_or.accumulate(diff, axis=1)
        new_prefix = np.concatenate([np.ones((1, L), bool), changed], axis=0)
    else:
        new_prefix = np.ones((1, L), bool)

    within = np.cumsum(new_prefix, axis=0) - 1  # (n, L)
    n_per_level = within[-1] + 1

    # Global state ids: root=1, then levels 1..L contiguous. Sink=0.
    level_offsets = np.zeros(L + 2, dtype=np.int64)
    level_offsets[0] = 1
    level_offsets[1] = 2
    for lvl in range(1, L + 1):
        level_offsets[lvl + 1] = level_offsets[lvl] + n_per_level[lvl - 1]
    src_all, tok_all, dst_all = [], [], []
    for lvl in range(L):
        rows = np.nonzero(new_prefix[:, lvl])[0]
        tok = s[rows, lvl]
        dst = level_offsets[lvl + 1] + within[rows, lvl]
        if lvl == 0:
            src = np.ones(rows.shape[0], dtype=np.int64)
        else:
            src = level_offsets[lvl] + within[rows, lvl - 1]
        src_all.append(src)
        tok_all.append(tok)
        dst_all.append(dst)
    # Per-level max branch factor (paper §4.4), before trimming.
    level_bmax = np.zeros(L, dtype=np.int64)
    for lvl in range(L):
        if src_all[lvl].size:
            base = 1 if lvl == 0 else int(level_offsets[lvl])
            level_bmax[lvl] = int(np.bincount(src_all[lvl] - base).max())

    # Dense levels (< dense_d) are served by the bit-packed tables, so their
    # CSR rows are trimmed and the remaining states renumbered from 1.
    d_eff = min(dense_d, L)
    shift = int(level_offsets[d_eff]) - 1
    if d_eff < L:
        src = np.concatenate(src_all[d_eff:]) - shift
        tok = np.concatenate(tok_all[d_eff:])
        dst = np.concatenate(dst_all[d_eff:]) - shift
    else:
        src = np.zeros(0, dtype=np.int64)
        tok = np.zeros(0, dtype=np.int64)
        dst = np.zeros(0, dtype=np.int64)
    n_edges = src.shape[0]
    n_states = int(level_offsets[-1]) - shift
    new_offsets = np.maximum(level_offsets - shift, 1)
    new_offsets[: d_eff] = 1

    counts = np.bincount(src, minlength=n_states)
    row_pointers = np.zeros(n_states + 1, dtype=np.int64)
    np.cumsum(counts, out=row_pointers[1:])
    csr_order = np.argsort(src, kind="stable")
    edges_unpadded = np.stack([tok[csr_order], dst[csr_order]], axis=1)

    # Tail pad: a speculative burst of any bmax from the final row stays in
    # bounds (same size as the reference builder's pad).
    pad = -int(level_bmax.max()) % 128 + int(level_bmax.max()) + 128
    check_index_capacity(index_dtype, n_states=n_states,
                         n_edge_rows=n_edges + pad, vocab_size=vocab_size)
    edges = np.concatenate(
        [edges_unpadded, np.zeros((pad, 2), dtype=edges_unpadded.dtype)], axis=0
    ).astype(index_dtype)
    row_pointers = row_pointers.astype(index_dtype)

    trie = FlatTrie(
        vocab_size=vocab_size,
        sid_length=L,
        n_constraints=n,
        row_pointers=row_pointers,
        edges=edges,
        n_states=n_states,
        n_edges=int(n_edges),
        level_offsets=new_offsets,
        level_bmax=level_bmax,
        dense_d=dense_d,
    )

    # ---- Dense acceleration tables (paper §A.1.2) ----
    if dense_d >= 1:
        l0_mask = np.zeros(vocab_size, dtype=bool)
        l0_states = np.zeros(vocab_size, dtype=index_dtype)
        rows0 = np.nonzero(new_prefix[:, 0])[0]
        y1 = s[rows0, 0]
        l0_mask[y1] = True
        if dense_d == 1 or L < 2:
            # real (renumbered) CSR ids: the next step indexes the CSR
            l0_states[y1] = (level_offsets[1] + within[rows0, 0]) - shift
        else:
            # virtual token-indexed ids (paper Appendix E): step 1 recovers
            # the parent token as node - 1
            l0_states[y1] = y1 + 1
        trie.l0_mask_packed = pack_bits(l0_mask)
        trie.l0_states = l0_states
    if dense_d >= 2 and L >= 2:
        l1_mask = np.zeros((vocab_size, vocab_size), dtype=bool)
        l1_states = np.zeros((vocab_size, vocab_size), dtype=index_dtype)
        rows1 = np.nonzero(new_prefix[:, 1])[0]
        y1 = s[rows1, 0]
        y2 = s[rows1, 1]
        l1_mask[y1, y2] = True
        l1_states[y1, y2] = (level_offsets[2] + within[rows1, 1]) - shift
        trie.l1_mask_packed = pack_bits(l1_mask)
        trie.l1_states = l1_states
    return trie



@dataclasses.dataclass(frozen=True)
class LevelBlocks:
    """Per-level structure of a canonical CSR slab (DESIGN.md §11).

    ``build_flat_trie`` emits edges level-major with, per level, consecutive
    destination states (``dst[e] = e + base`` over the level's edge block)
    and token-ascending rows.  Indexing is by decode step ``s``:
      * ``edge_offsets (L+1,)`` — step-``s`` edges occupy
        ``[edge_offsets[s], edge_offsets[s+1])`` (empty on dense steps);
      * ``base (L,)`` — ``next_state = edge_index + base[s]`` (0 on dense
        steps);
      * ``state_offsets (L+2,)`` — first state id of each level (1 for the
        trimmed dense levels).
    """

    edge_offsets: np.ndarray
    base: np.ndarray
    state_offsets: np.ndarray


def infer_level_blocks(row_pointers, edges, *, n_states: int, n_edges: int,
                       sid_length: int, dense_d: int,
                       vocab_size: int | None = None) -> LevelBlocks:
    """Recover and verify the per-level blocks of a bare ``(row_pointers,
    edges)`` pair (numpy arrays or torch tensors, read on their device).

    The blocks follow from two facts of the canonical builder's output:
    states of one level are contiguous, and each level's edges target the
    next level's consecutive states.  Every inferred property is then
    checked against the arrays; a slab the canonical builder did not make
    (or a corrupted one) raises ``ValueError``.
    """
    L = int(sid_length)
    d_eff = min(int(dense_d), L)
    E = int(n_edges)
    edge_offsets = np.zeros(L + 1, dtype=np.int64)
    base = np.zeros(L, dtype=np.int64)
    state_offsets = np.ones(L + 2, dtype=np.int64)
    if E == 0:  # fully dense trie: leaves only, no CSR edges
        state_offsets[d_eff + 1:] = n_states
        return LevelBlocks(edge_offsets, base, state_offsets)
    rp = torch.as_tensor(row_pointers)[: n_states + 1].long()
    eg = torch.as_tensor(edges)
    tok, dst = eg[:E, 0].long(), eg[:E, 1].long()

    # state-block bounds per level from the first sparse level on: the first
    # edge's destination opens the next level, and each block's out-degree
    # is the size of the block it feeds
    bounds = [1, int(dst[0])]
    while bounds[-1] < n_states:
        lo, hi = bounds[-2], bounds[-1]
        if not 1 <= lo < hi <= n_states:
            raise ValueError(
                f"non-canonical CSR slab: level bounds {bounds} do not "
                f"partition states [1, {n_states})")
        n_out = int(rp[hi] - rp[lo])
        if n_out <= 0:
            raise ValueError(
                "non-canonical CSR slab: empty intermediate level block")
        bounds.append(hi + n_out)
    if bounds[-1] != n_states or len(bounds) - 1 != L - d_eff + 1:
        raise ValueError(
            f"non-canonical CSR slab: inferred {len(bounds) - 1} level "
            f"blocks over {bounds[-1]} states, expected {L - d_eff + 1} "
            f"blocks over {n_states}")

    for b in range(len(bounds) - 2):  # edge-bearing steps d_eff .. L-1
        s = d_eff + b
        e0, e1 = int(rp[bounds[b]]), int(rp[bounds[b + 1]])
        edge_offsets[s] = e0
        edge_offsets[s + 1:] = e1
        base[s] = bounds[b + 1] - e0
        want = torch.arange(e0, e1, device=dst.device) + int(base[s])
        if not torch.equal(dst[e0:e1], want):
            raise ValueError(
                f"non-canonical CSR slab: step-{s} destinations are not "
                f"consecutive (base {base[s]})")
    edge_offsets[L] = E
    for b, v in enumerate(bounds):  # bounds[b]: first state of level d_eff+b
        state_offsets[d_eff + b] = v

    # rows strictly token-ascending: the deltas are positive, and the §8
    # tie order assumes it
    if E > 1:
        mark = torch.zeros(E + 1, dtype=torch.bool, device=tok.device)
        mark[rp[:-1]] = True
        if not bool(((tok[1:] > tok[:-1]) | mark[1:E]).all()):
            raise ValueError(
                "non-canonical CSR slab: row tokens are not strictly "
                "ascending")
    if int(tok.min()) < 0 or (vocab_size is not None
                              and int(tok.max()) >= vocab_size):
        raise ValueError("non-canonical CSR slab: edge tokens out of range")
    return LevelBlocks(edge_offsets, base, state_offsets)


def random_constraint_set(
    rng: np.random.Generator, n: int, vocab_size: int, length: int
) -> np.ndarray:
    """Uniform random constraint set (paper §5.3 scalability protocol):
    ``(n, length)`` int64 SIDs, the reference's draw from the same ``rng``."""
    return rng.integers(0, vocab_size, size=(n, length), dtype=np.int64)
