"""Trie-aware training signal: per-prefix admissible-set statistics (a numpy
copy of ``repro.scenarios.trie_signal``).

Trie-Aware Transformers (arxiv 2602.21677, PAPERS.md) feed the decoding
trie's structure back into *training*: at every SID position the model is
told (or regularized toward) the set of tokens the constrained decoder will
actually admit.  This module derives those statistics from the same sorted
SID slab the refresh layer retains (:class:`~repro_torch.constraints.refresh
.TrieSource`) — the trie is never materialized; everything falls out of
run-length structure over the lexsorted rows, the exact technique
``TrieSource._assemble`` uses to rebuild the CSR:

  * a row starts a new ``(l+1)``-prefix iff it differs from its predecessor
    in some column ``<= l``;
  * the admissible set after an ``l``-prefix is the set of distinct
    ``(l+1)``-prefix starts inside that prefix's row range;
  * so per-level sizes are ``searchsorted`` diffs and per-level masks are
    one scatter per level — O(N·L) + O(groups·V) host work, run once per
    tokenization.

The :class:`~repro_torch.scenarios.stages.TrainStage` gates this behind
``TrainConfig.trie_aware_weight`` (default 0.0 = off): when on, the stats
are computed over the WARM-item trie (cold items are invisible at train
time, matching the serving-side information the model could legitimately
see) and fed to :func:`~repro_torch.models.transformer.lm_loss_trie_aware` as the
admissible-mass auxiliary loss.
"""
from __future__ import annotations

import numpy as np

from repro_torch.constraints.refresh import TrieSource, row_keys

__all__ = [
    "admissible_stats",
    "source_admissible",
    "map_items_to_slab",
    "item_admissible",
]


def _stats_sorted(s: np.ndarray, vocab_size: int):
    """Stats over LEXSORTED rows ``s`` (N, L) -> (sizes (N, L), masks
    (N, L, V)).

    ``sizes[i, l]`` = |admissible tokens after prefix ``s[i, :l]``|;
    ``masks[i, l, t]`` = True iff token ``t`` is admissible there (i.e. some
    row extends ``s[i, :l]`` with ``t``).  Level 0 is the root: one group
    spanning every row.
    """
    N, L = s.shape
    sizes = np.empty((N, L), dtype=np.int32)
    masks = np.zeros((N, L, vocab_size), dtype=bool)
    # new[l, i]: row i starts a new (l+1)-prefix
    new = np.ones((L, N), dtype=bool)
    for lvl in range(L):
        if N > 1:
            new[lvl, 1:] = (
                s[1:, : lvl + 1] != s[:-1, : lvl + 1]
            ).any(axis=1)
    for lvl in range(L):
        if lvl == 0:
            pos_prev = np.zeros(1, dtype=np.int64)  # the root group
            g_of_row = np.zeros(N, dtype=np.int64)
        else:
            pos_prev = np.flatnonzero(new[lvl - 1])
            g_of_row = np.cumsum(new[lvl - 1]) - 1
        pos_l = np.flatnonzero(new[lvl])  # starts of distinct children
        counts = np.diff(np.searchsorted(pos_l, np.append(pos_prev, N)))
        sizes[:, lvl] = counts[g_of_row]
        g_of_start = np.searchsorted(pos_prev, pos_l, side="right") - 1
        gm = np.zeros((pos_prev.shape[0], vocab_size), dtype=bool)
        gm[g_of_start, s[pos_l, lvl]] = True
        masks[:, lvl] = gm[g_of_row]
    return sizes, masks


def admissible_stats(sids: np.ndarray, vocab_size: int):
    """Per-row admissible stats of the trie over ``sids``, in input order.

    Returns ``(sizes (N, L) int32, masks (N, L, V) bool)`` where row ``i``
    describes the decoder's view along item ``i``'s own SID path:
    ``masks[i, l]`` is the admissible token set after emitting
    ``sids[i, :l]``.  Rows need not be sorted or unique.
    """
    s = np.asarray(sids, dtype=np.int64)
    if s.ndim != 2:
        raise ValueError(f"sids must be (N, L), got shape {s.shape}")
    order = np.lexsort(tuple(s[:, c] for c in range(s.shape[1] - 1, -1, -1)))
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    sizes, masks = _stats_sorted(s[order], vocab_size)
    return sizes[inv], masks[inv]


def source_admissible(source: TrieSource):
    """Stats over a TrieSource's retained slab, in slab (sorted) order.

    Returns ``(slab_sids (N, L) int64, sizes (N, L), masks (N, L, V))`` —
    the slab view is already lexsorted and unique, so this skips the sort.
    """
    slab = np.asarray(source.sids, dtype=np.int64)
    sizes, masks = _stats_sorted(slab, source.vocab_size)
    return slab, sizes, masks


def map_items_to_slab(item_sids: np.ndarray,
                      slab_sids: np.ndarray) -> np.ndarray:
    """Catalog-order item SIDs -> their row indices in the sorted slab.

    Raises if any item is absent from the slab: feeding a cold item's
    prefix statistics into training would leak the held-out set.
    """
    item_sids = np.asarray(item_sids, dtype=np.int64)
    slab_sids = np.asarray(slab_sids, dtype=np.int64)
    slab_keys = row_keys(slab_sids)
    item_keys = row_keys(item_sids)
    rows = np.searchsorted(slab_keys, item_keys)
    rows = np.clip(rows, 0, max(slab_keys.shape[0] - 1, 0))
    if slab_keys.shape[0] == 0 or not (slab_keys[rows] == item_keys).all():
        missing = int((slab_keys[rows] != item_keys).sum()) if \
            slab_keys.shape[0] else item_keys.shape[0]
        raise ValueError(
            f"{missing} item SID(s) not present in the trie slab"
        )
    return rows


def item_admissible(item_sids: np.ndarray, source: TrieSource):
    """Per-item stats in CATALOG order, from a TrieSource slab.

    Returns ``(sizes (N, L) int32, masks (N, L, V) bool)`` aligned with
    ``item_sids`` — the shape the TrainStage gathers per batch.
    """
    slab, sizes, masks = source_admissible(source)
    rows = map_items_to_slab(item_sids, slab)
    return sizes[rows], masks[rows]
