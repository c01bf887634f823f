"""KV caches: full, ring-buffered (sliding-window) and MLA latent
(``repro.models.kvcache``).

Layer-stacked ``(n_layers, B, S_slots, ...)`` arrays, the absolute position
of every slot (-1 = empty) and the next position to write.  A ring cache
keeps only ``window`` slots and writes position ``pos`` at ``pos % window``;
every slot remembers its absolute position for masking, so a sliding-window
decode holds O(window) memory however long the sequence.  The MLA cache
holds the compressed latents and the shared rotary keys instead of K/V.
The reference is functional; here the cache arrays are written in place (a
beam cache of the 3B model is ~4 GB), while ``slot_pos`` is small and is
replaced.

The paged history pools of the continuous engine (DESIGN.md §10) live here
too: :func:`init_page_pool`, :func:`scatter_pages` and :func:`gather_pages`.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["KVCache", "MLACache", "init_kv_cache", "init_mla_cache",
           "advance_positions", "write_slot", "pages_for", "init_page_pool",
           "scatter_pages", "gather_pages"]


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, B, S_slots, KVH, Dh)
    v: torch.Tensor  # (L, B, S_slots, KVH, Dh)
    slot_pos: torch.Tensor  # (S_slots,) int32 absolute position per slot
    pos: int  # next position to write
    ring: bool = False  # slots are a ring of the last S_slots positions


@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor  # (L, B, S, kv_lora) compressed latents
    k_rope: torch.Tensor  # (L, B, S, rope_dim) shared decoupled keys
    slot_pos: torch.Tensor  # (S,) int32
    pos: int


def init_kv_cache(n_layers, batch, max_len, n_kv_heads, head_dim, *,
                  dtype=torch.bfloat16, device=None,
                  window=None) -> KVCache:
    """Empty cache of ``min(max_len, window)`` slots; a ring exactly when
    the window is what bounds it (``slots == window``)."""
    slots = min(max_len, window) if window else max_len
    return KVCache(
        k=torch.zeros((n_layers, batch, slots, n_kv_heads, head_dim),
                      dtype=dtype, device=device),
        v=torch.zeros((n_layers, batch, slots, n_kv_heads, head_dim),
                      dtype=dtype, device=device),
        slot_pos=torch.full((slots,), -1, dtype=torch.int32, device=device),
        pos=0,
        ring=window is not None and slots == window,
    )


def init_mla_cache(n_layers, batch, max_len, kv_lora_rank, rope_dim, *,
                   dtype=torch.bfloat16, device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((n_layers, batch, max_len, kv_lora_rank),
                         dtype=dtype, device=device),
        k_rope=torch.zeros((n_layers, batch, max_len, rope_dim), dtype=dtype,
                           device=device),
        slot_pos=torch.full((max_len,), -1, dtype=torch.int32, device=device),
        pos=0,
    )


def write_slot(cache_arr: torch.Tensor, new: torch.Tensor, slot: int):
    """cache_arr (B, S, ...) <- new (B, 1, ...) at index ``slot``, in place."""
    cache_arr[:, slot:slot + 1] = new.to(cache_arr.dtype)
    return cache_arr


def advance_positions(slot_pos: torch.Tensor, pos: int, n_slots: int,
                      ring: bool = False):
    """Mark the slot written at this step with its absolute position:
    ``pos % n_slots`` on a ring, else ``min(pos, n_slots - 1)``.

    Returns ``(new slot_pos, slot)``; the slot is computed once here and
    handed to the attention write, so the two never disagree.
    """
    slot = pos % n_slots if ring else min(pos, n_slots - 1)
    new = slot_pos.clone()
    new[slot] = pos
    return new, slot


# ---------------------------------------------------------------------------
# Paged history pools (continuous batching, DESIGN.md §10)
# ---------------------------------------------------------------------------
def pages_for(seq_len: int, page_size: int) -> int:
    """Pages needed to hold ``seq_len`` KV columns."""
    return -(-int(seq_len) // int(page_size))


def init_page_pool(n_layers: int, n_pages: int, page_size: int,
                   n_kv_heads: int, head_dim: int, v_dim=None, *,
                   dtype: torch.dtype, device) -> tuple:
    """(k_pool, v_pool), each (n_layers, n_pages, page_size, KVH, Dh), zeros.

    Page 0 is the allocator's NULL page (never handed out), so an all-zero
    page table is always safe to gather through.
    """
    v_dim = v_dim or head_dim
    return (
        torch.zeros((n_layers, n_pages, page_size, n_kv_heads, head_dim),
                    dtype=dtype, device=device),
        torch.zeros((n_layers, n_pages, page_size, n_kv_heads, v_dim),
                    dtype=dtype, device=device),
    )


def scatter_pages(pool: torch.Tensor, rows: torch.Tensor,
                  page_ids: torch.Tensor) -> torch.Tensor:
    """Commit prefilled KV rows into the pool at ``page_ids``, in place.

    pool (n_layers, P, ps, KVH, Dh); rows (n_layers, B, S, KVH, Dh), ``S``
    padded with zeros up to ``n_pages_per_row * ps``; page_ids (B,
    n_pages_per_row) integer.  Rows sharing a page id (refcounted prompt
    sharing) must carry identical content: which one lands is undefined.
    """
    n_layers, ps = pool.shape[0], pool.shape[2]
    B, S = rows.shape[1], rows.shape[2]
    n_per = page_ids.shape[1]
    pad = n_per * ps - S
    if pad:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
    paged = rows.reshape(n_layers, B * n_per, ps, *rows.shape[3:])
    pool[:, page_ids.reshape(-1).long()] = paged.to(pool.dtype)
    return pool


def gather_pages(pool_layer: torch.Tensor, page_table: torch.Tensor,
                 hist_len: int) -> torch.Tensor:
    """Read ``hist_len`` history columns per slot through the page table.

    pool_layer (P, ps, KVH, Dh); page_table (slots, n_pages) ->
    (slots, hist_len, KVH, Dh).  The trailing ``n_pages*ps - hist_len``
    columns are sliced off, so page-granule padding never reaches
    attention (an exact-width history keeps the softmax reduction the
    contiguous cache's).
    """
    slots, n_pages = page_table.shape
    ps = pool_layer.shape[1]
    flat = pool_layer.index_select(0, page_table.reshape(-1).long())
    return flat.reshape(slots, n_pages * ps, *pool_layer.shape[2:])[
        :, :hist_len]
