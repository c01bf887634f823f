"""Host-side ownership of the paged history KV pool (DESIGN.md §10).

A copy of ``repro.serving.continuous.paged_kv`` (host-only Python, no
tensors).  The device never sees allocation: pools are flat ``(n_layers, P,
page_size, KVH, Dh)`` tensors
(``repro_torch.models.kvcache.init_page_pool``) and the decode step reads
them through a page table.  Everything that *changes over
time at dynamic granularity* — which pages belong to which slot, how many
slots reference a shared prompt's pages — lives here as plain Python, so
join/evict/share never touches a traced shape.

Two pieces:

* :class:`PagedKVAllocator` — free-list + refcounts over page ids
  ``1..n_pages-1`` (page 0 is the reserved NULL/scratch page: dead slots'
  page-table rows are all-zero, and prefill padding rows scatter there).
  Invariant, checked on every mutation in debug mode and exposed as
  :meth:`check`: every page is on the free list XOR has refcount >= 1.
* :class:`PrefixShareTable` — maps prompt bytes -> (page ids, first-token
  logits row).  A hit at admission reuses the donor's pages (one
  ``retain``) and skips the prefill entirely; prefill is row-independent,
  so the skipped computation is bitwise the one the donor already ran.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from repro_torch.reliability.faults import fire

__all__ = ["PagedKVAllocator", "PrefixShareTable"]

NULL_PAGE = 0


class PagedKVAllocator:
    """Refcounted free-list allocator over pool pages ``1..n_pages-1``."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least one allocatable page beyond NULL")
        self.n_pages = int(n_pages)
        # LIFO free list: recently released pages are re-handed first, which
        # keeps the hot working set of pool pages small.
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._ref: dict[int, int] = {}

    # -- introspection ------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_referenced(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(int(page), 0)

    def utilization(self) -> float:
        """Fraction of allocatable pages currently referenced."""
        return self.n_referenced / max(self.n_pages - 1, 1)

    def check(self) -> None:
        """Assert the ownership invariant; raises AssertionError on breach."""
        free = set(self._free)
        held = set(self._ref)
        assert len(free) == len(self._free), "duplicate page on free list"
        assert not (free & held), f"pages both free and referenced: {free & held}"
        assert NULL_PAGE not in free and NULL_PAGE not in held, \
            "NULL page entered circulation"
        assert len(free) + len(held) == self.n_pages - 1, (
            f"page leak: {len(free)} free + {len(held)} held "
            f"!= {self.n_pages - 1}"
        )
        assert all(c >= 1 for c in self._ref.values()), "zero refcount held"

    # -- mutation -----------------------------------------------------------
    def alloc(self, n: int) -> list[int]:
        """Hand out ``n`` pages at refcount 1; raises MemoryError when the
        pool cannot satisfy the request (the caller sheds or waits)."""
        # fault point sits BEFORE any mutation, so an injected allocation
        # failure leaves the free ⊎ referenced invariant intact by
        # construction (chaos harness calls check() after every fire)
        fire("kv.page_alloc")
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            p = int(p)
            if p not in self._ref:
                raise ValueError(f"retain of unowned page {p}")
            self._ref[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            p = int(p)
            c = self._ref.get(p)
            if c is None:
                raise ValueError(f"double free of page {p}")
            if c == 1:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] = c - 1


class PrefixShareTable:
    """Prompt-prefix -> (pages, first logits) with refcount-aware eviction.

    Keyed on the *padded prompt bytes* (the exact ``(S,)`` int32 row the
    prefill would consume), so a hit guarantees the skipped prefill computes
    bit-for-bit what the stored pages and logits row already hold — prefill
    rows are batch-independent.  Constraint ids do NOT enter the key: the
    prefill is model-only, so tenants share prompt KV safely.

    The table holds one allocator reference per entry; LRU eviction (and
    :meth:`drop_all`) releases it.  Capacity bounds pool pressure:
    an entry's pages stay resident while cached even with no live slot
    using them, which is the point — the next identical prompt skips its
    prefill.
    """

    def __init__(self, allocator: PagedKVAllocator, capacity: int = 64):
        self._alloc = allocator
        self.capacity = int(capacity)
        self._entries: "OrderedDict[bytes, tuple[tuple[int, ...], np.ndarray]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def key_of(prompt_row: np.ndarray) -> bytes:
        return np.ascontiguousarray(prompt_row, np.int32).tobytes()

    def contains(self, prompt_row: np.ndarray) -> bool:
        """Side-effect-free probe (no retain, no hit/miss accounting) —
        admission *planning* asks this; the actual admission calls
        :meth:`lookup`."""
        return self.key_of(prompt_row) in self._entries

    def lookup(self, prompt_row: np.ndarray) -> Optional[tuple[tuple[int, ...], np.ndarray]]:
        """On hit: ``(page_ids, first_logits_row)`` with the pages *already
        retained* for the caller (one new reference)."""
        k = self.key_of(prompt_row)
        hit = self._entries.get(k)
        if hit is None:
            self.misses += 1
            return None
        self._entries.move_to_end(k)
        self._alloc.retain(hit[0])
        self.hits += 1
        return hit

    def insert(self, prompt_row: np.ndarray, pages: Sequence[int],
               first_logits_row: np.ndarray) -> None:
        """Cache a freshly prefilled prompt.  Takes its own reference on
        ``pages``; evicts LRU entries beyond capacity."""
        if self.capacity <= 0:
            return
        k = self.key_of(prompt_row)
        if k in self._entries:  # racing duplicate prefill; keep the old one
            return
        self._alloc.retain(pages)
        self._entries[k] = (
            tuple(int(p) for p in pages),
            np.array(first_logits_row, np.float32, copy=True),
        )
        while len(self._entries) > self.capacity:
            _, (old_pages, _) = self._entries.popitem(last=False)
            self._alloc.release(old_pages)

    def drop_all(self) -> None:
        for pages, _ in self._entries.values():
            self._alloc.release(pages)
        self._entries.clear()
