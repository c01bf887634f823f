"""KV cache of the GQA decode path (``repro.models.kvcache.KVCache``).

Layer-stacked ``(n_layers, B, S_slots, KVH, Dh)`` arrays, the absolute
position of every slot (-1 = empty) and the next position to write.  The
reference is functional; here the cache arrays are written in place (a
beam cache of the 3B model is ~4 GB), while ``slot_pos`` is small and is
replaced.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["KVCache", "advance_positions", "write_slot"]


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, B, S_slots, KVH, Dh)
    v: torch.Tensor  # (L, B, S_slots, KVH, Dv)
    slot_pos: torch.Tensor  # (S_slots,) int32 absolute position per slot
    pos: int  # next position to write


def write_slot(cache_arr: torch.Tensor, new: torch.Tensor, slot: int):
    """cache_arr (B, S, ...) <- new (B, 1, ...) at index ``slot``, in place."""
    cache_arr[:, slot:slot + 1] = new.to(cache_arr.dtype)
    return cache_arr


def advance_positions(slot_pos: torch.Tensor, pos: int, n_slots: int):
    """Mark the slot written at this step with its absolute position.

    Returns ``(new slot_pos, slot)``; the slot is computed once here and
    handed to the attention write, so the two never disagree.
    """
    slot = min(pos, n_slots - 1)
    new = slot_pos.clone()
    new[slot] = pos
    return new, slot
