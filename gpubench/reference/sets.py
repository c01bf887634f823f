"""Constraint sets worked out from the catalog the benchmark made.

A :class:`Catalog` holds every item's Semantic ID, lexicographically sorted
(checked here, sorted here if it is not), with the item metadata the slot
predicates read.  A set is the catalog's rows that a predicate keeps, so it is
sorted too, and that sorted table serves as the reference's trie: the items
under a prefix are one contiguous run of rows, and a prefix's children are
the runs of equal values in the next column inside it.

Membership of a served SID is a binary search over the rows' packed keys
(as many tokens as fit 63 bits to a key), then the set's mask at that row.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Catalog", "SidSet", "PREDICATES"]


def freshness_window(meta: dict, max_age_days: float) -> np.ndarray:
    """Items no older than ``max_age_days``."""
    return meta["age_days"] <= max_age_days


def category_allowlist(meta: dict, *categories: int) -> np.ndarray:
    """Items whose category is one of ``categories``."""
    return np.isin(meta["category"], np.asarray(categories))


PREDICATES = {"freshness_window": freshness_window,
              "category_allowlist": category_allowlist}


def _is_strictly_sorted(sids: np.ndarray) -> bool:
    if sids.shape[0] < 2:
        return True
    diff = sids[1:] != sids[:-1]
    first = diff.argmax(axis=1)
    rows = np.arange(sids.shape[0] - 1)
    return bool((diff[rows, first]
                 & (sids[1:][rows, first] > sids[:-1][rows, first])).all())


def _pack(sids: np.ndarray, vocab: int) -> np.ndarray:
    """(N, L) tokens -> (N, K) int64 keys whose lexicographic order is the
    rows' order."""
    per_key = 1
    while vocab ** (per_key + 1) < 2 ** 63:
        per_key += 1
    keys = []
    for c0 in range(0, sids.shape[1], per_key):
        k = np.zeros(sids.shape[0], np.int64)
        for c in range(c0, min(c0 + per_key, sids.shape[1])):
            k = k * vocab + sids[:, c].astype(np.int64)
        keys.append(k)
    return np.stack(keys, axis=1)


class SidSet:
    """One constraint set: its SIDs as sorted rows (N, L), kept a column
    at a time so that a run of rows is a contiguous slice to search."""

    def __init__(self, rows: np.ndarray):
        self.cols = [np.ascontiguousarray(rows[:, c])
                     for c in range(rows.shape[1])]
        self._root = None

    def __len__(self) -> int:
        return self.cols[0].shape[0]

    def children(self, lo: int, hi: int, level: int):
        """The tokens that extend the prefix whose rows are ``[lo, hi)`` at
        ``level``, and each child's row range: (tokens, los, his)."""
        if level == 0 and lo == 0 and hi == len(self) and self._root:
            return self._root
        col = self.cols[level][lo:hi]
        cut = np.flatnonzero(col[1:] != col[:-1]) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [hi - lo]])
        out = (col[starts].astype(np.int64), starts + lo, ends + lo)
        if level == 0 and lo == 0 and hi == len(self):
            self._root = out
        return out

    def prefix_range(self, prefix) -> tuple:
        """Rows ``[lo, hi)`` of the SIDs that start with ``prefix`` (empty
        when none does)."""
        lo, hi = 0, len(self)
        for level, tok in enumerate(prefix):
            col = self.cols[level][lo:hi]
            tok = col.dtype.type(tok)  # a key of another dtype copies col
            lo, hi = (lo + int(np.searchsorted(col, tok, "left")),
                      lo + int(np.searchsorted(col, tok, "right")))
            if lo == hi:
                break
        return lo, hi


class Catalog:
    """The catalog's sorted SIDs (N, L), its metadata and its slots."""

    def __init__(self, sids: np.ndarray, vocab: int, meta: dict | None = None,
                 slots: list | None = None):
        sids = np.asarray(sids)
        if not _is_strictly_sorted(sids):
            order = np.lexsort(tuple(sids[:, c] for c in
                                     range(sids.shape[1] - 1, -1, -1)))
            sids = sids[order]
            meta = {k: np.asarray(v)[order] for k, v in (meta or {}).items()}
            keep = np.concatenate([[True], np.any(sids[1:] != sids[:-1], 1)])
            sids = sids[keep]
            meta = {k: v[keep] for k, v in meta.items()}
        self.sids = sids
        self.vocab = vocab
        self.meta = meta or {}
        self.slots = slots or []
        self._keys = _pack(sids, vocab)
        self._masks: dict = {}
        self._sets: dict = {}
        self._first: dict = {}

    def mask(self, cid) -> np.ndarray | None:
        """Rows of set ``cid`` (None: the whole catalog, the single set)."""
        if cid is None:
            return None
        if cid not in self._masks:
            slot = self.slots[cid]
            self._masks[cid] = np.asarray(PREDICATES[slot["predicate"]](
                self.meta, *slot["args"]), bool)
        return self._masks[cid]

    def set(self, cid) -> SidSet:
        if cid not in self._sets:
            m = self.mask(cid)
            self._sets[cid] = SidSet(self.sids if m is None else self.sids[m])
        return self._sets[cid]

    def first_tokens(self, cid) -> int:
        """Distinct first tokens of set ``cid``."""
        if cid not in self._first:
            m = self.mask(cid)
            first = self.sids[:, 0] if m is None else self.sids[m, 0]
            self._first[cid] = int(np.count_nonzero(
                np.bincount(first, minlength=self.vocab)))
        return self._first[cid]

    def rows_of(self, queries: np.ndarray) -> np.ndarray:
        """Catalog row of each query SID (Q, L), -1 where it is no item."""
        q = _pack(np.asarray(queries), self.vocab)
        keys = self._keys
        lo = np.searchsorted(keys[:, 0], q[:, 0], "left")
        hi = np.searchsorted(keys[:, 0], q[:, 0], "right")
        out = np.full(q.shape[0], -1, np.int64)
        one = np.flatnonzero(hi - lo == 1)  # the common case: a unique head
        hit = np.all(keys[lo[one], 1:] == q[one, 1:], axis=1)
        out[one[hit]] = lo[one[hit]]
        for i in np.flatnonzero(hi - lo > 1):
            a, b = lo[i], hi[i]
            for j in range(1, keys.shape[1]):
                a, b = (a + np.searchsorted(keys[a:b, j], q[i, j], "left"),
                        a + np.searchsorted(keys[a:b, j], q[i, j], "right"))
            if b > a:
                out[i] = a
        return out

    def contains(self, cid, queries: np.ndarray) -> np.ndarray:
        """Whether each query SID (Q, L) is in set ``cid``."""
        rows = self.rows_of(queries)
        found = rows >= 0
        m = self.mask(cid)
        if m is not None:
            found[found] = m[rows[found]]
        return found
