"""Dense bit-packed prefix-mask lookups for the first ``d`` levels (§A.1.2).

Counterparts of ``repro.core.dense_mask``.  Bit order is little-endian
within each uint8 word (see ``trie.pack_bits``).  Both lookups take an
optional per-row ``constraint_ids``: ``tm`` is then a stacked
:class:`~repro_torch.constraints.ConstraintStore` and the dense tables gain
one leading gather ``tables[cid, ...]`` (ids clamped into ``[0, K)``, as the
reference's gather clamps them).  Without ids the single-matrix path is
unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.core.vntk import NEG_INF

__all__ = ["unpack_mask_row", "dense_lookup_l0", "dense_lookup_l1"]


def unpack_mask_row(packed: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(..., ceil(V/8)) uint8 -> (..., V) bool via shift-and-mask."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    bits = bits.reshape(packed.shape[:-1] + (-1,))
    return bits[..., :vocab_size].bool()


def _ids(constraint_ids: torch.Tensor, store) -> torch.Tensor:
    return constraint_ids.long().clamp(0, store.num_sets - 1)


def dense_lookup_l0(log_probs: torch.Tensor, tm: TransitionMatrix,
                    constraint_ids: Optional[torch.Tensor] = None):
    """Decode step 0: mask by the root's dense start mask.

    ``l0_states`` holds the id space the next step expects: virtual
    ``token + 1`` ids under ``dense_d == 2``, real CSR ids under 1.
    """
    if constraint_ids is None:
        packed, states = tm.l0_mask_packed, tm.l0_states  # (V/8,), (V,)
    else:  # per-row root mask: (..., V/8), (..., V)
        cid = _ids(constraint_ids, tm)
        packed, states = tm.l0_mask_packed[cid], tm.l0_states[cid]
    mask = unpack_mask_row(packed, tm.vocab_size)
    masked = torch.where(mask, log_probs, NEG_INF)
    nxt = torch.where(mask, states, 0)
    return masked, nxt.expand(log_probs.shape).to(torch.int32)


def dense_lookup_l1(log_probs: torch.Tensor, nodes: torch.Tensor,
                    tm: TransitionMatrix,
                    constraint_ids: Optional[torch.Tensor] = None):
    """Decode step 1 under dense_d == 2: lookup into the (V, V) tables."""
    V = tm.vocab_size
    parents = (nodes.long() - 1).clamp(0, V - 1)  # recover the parent token
    if constraint_ids is None:
        packed, states = tm.l1_mask_packed[parents], tm.l1_states[parents]
    else:
        cid = _ids(constraint_ids, tm)
        packed = tm.l1_mask_packed[cid, parents]
        states = tm.l1_states[cid, parents]
    mask = unpack_mask_row(packed, V)  # (..., V)
    mask = mask & (nodes > 0)[..., None]  # a sink parent has no continuation
    masked = torch.where(mask, log_probs, NEG_INF)
    next_dense = torch.where(mask, states, 0).to(torch.int32)
    return masked, next_dense
