"""Delta-compressed CSR edge slab for large catalogs (DESIGN.md §11).

Counterpart of ``repro.core.compressed_slab``.  The uncompressed CSR spends
8 B per edge (an int32 token and an int32 next state); both are redundant
under the canonical builder layout (:func:`~repro_torch.core.trie.
infer_level_blocks`):

  * **tokens** ascend strictly within a row, so each edge stores the delta
    to its left neighbour and a row start keeps the absolute token; deltas
    are at most ``vocab_size - 1``, so a vocab ``<= 32768`` fits int16;
  * **next states** are consecutive over each level's edge block
    (``dst[e] = e + base[level]``), so the next-state column collapses to a
    per-level base table.

Decoding is one int32 prefix sum over a speculative burst that starts at a
row start: ``vntk_compressed_*`` in :mod:`repro_torch.core.vntk` (plain) and
the compressed modes of the CUDA kernels in :mod:`repro_torch.kernels.vntk`.
Outputs equal the uncompressed path's bit for bit.

The reference encodes on the host in numpy, member by member.  The port
encodes in torch on the tables' own device, in int64, with the same
round-trip check; the arrays equal the reference's.  A slab that is not in
the canonical layout raises; there is no fallback.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.trie import infer_level_blocks

__all__ = ["CompressedSlab", "INT16_MAX_VOCAB"]

# Largest vocab whose tokens and deltas (<= V-1) fit an int16 delta slab.
INT16_MAX_VOCAB = 32768


def _slab_dtype(vocab_size: int) -> torch.dtype:
    return torch.int16 if vocab_size <= INT16_MAX_VOCAB else torch.int32


def _delta_encode(row_pointers, edges, out, *, n_states, n_edges, sid_length,
                  dense_d, vocab_size) -> np.ndarray:
    """Write one member's delta tokens into ``out`` (its ``(E+pad,)`` row,
    zero past ``n_edges``), verified; returns its ``(L,)`` int32 bases."""
    blocks = infer_level_blocks(
        row_pointers, edges, n_states=n_states, n_edges=n_edges,
        sid_length=sid_length, dense_d=dense_d, vocab_size=vocab_size)
    E = int(n_edges)
    out.zero_()
    if E:
        tok = edges[:E, 0].long()
        mark = torch.zeros(E + 1, dtype=torch.bool, device=tok.device)
        mark[row_pointers[:n_states].long()] = True  # rows keep the absolute
        d = tok.clone()
        d[1:] = torch.where(mark[1:E], tok[1:], tok[1:] - tok[:-1])
        # round trip: the segment prefix sum (the kernels' decode) must
        # recover every token; this is the whole bit-identity contract
        c = torch.cumsum(d, 0)
        starts = torch.nonzero(mark[:E]).squeeze(1)
        gov = starts[torch.cumsum(mark[:E], 0) - 1]  # each edge's row start
        if not torch.equal(c - (c[gov] - d[gov]), tok):
            raise ValueError("delta encoding failed round-trip verification")
        out[:E] = d.to(out.dtype)
    return blocks.base.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class CompressedSlab:
    """Device-resident compressed edge slab (single matrix or stacked store).

    Tensor shapes and dtypes are functions of the envelope only, so a hot
    swap that recomputes the slab keeps them (and the retriever's policy
    signature) unchanged.
    """

    tok_delta: torch.Tensor  # (E+pad,) or (K, E+pad) int16|int32 deltas
    level_base: torch.Tensor  # (L,) or (K, L) int32: next = edge + base[step]
    vocab_size: int
    sid_length: int

    @classmethod
    def from_matrix(cls, tm) -> "CompressedSlab":
        """Compress one :class:`TransitionMatrix` on its device."""
        tok = torch.empty(tm.edges.shape[-2], dtype=_slab_dtype(tm.vocab_size),
                          device=tm.edges.device)
        base = _delta_encode(
            tm.row_pointers, tm.edges, tok, n_states=tm.n_states,
            n_edges=tm.n_edges, sid_length=tm.sid_length, dense_d=tm.dense_d,
            vocab_size=tm.vocab_size)
        return cls(tok_delta=tok,
                   level_base=torch.from_numpy(base).to(tok.device),
                   vocab_size=int(tm.vocab_size),
                   sid_length=int(tm.sid_length))

    @classmethod
    def from_store(cls, store) -> "CompressedSlab":
        """Compress every member of a stacked ConstraintStore.

        Each member's real prefix is encoded on its own and the rest of its
        row is zero: zero deltas decode to a constant run past the row end
        that the ``slot < n_child`` test never admits.
        """
        dev = store.edges.device
        toks = torch.empty((store.num_sets, store.edges.shape[-2]),
                           dtype=_slab_dtype(store.vocab_size), device=dev)
        bases = np.zeros((store.num_sets, store.sid_length), dtype=np.int32)
        for k in range(store.num_sets):
            m = store.member(k)
            bases[k] = _delta_encode(
                m.row_pointers, m.edges, toks[k], n_states=m.n_states,
                n_edges=m.n_edges, sid_length=m.sid_length, dense_d=m.dense_d,
                vocab_size=m.vocab_size)
        return cls(tok_delta=toks, level_base=torch.from_numpy(bases).to(dev),
                   vocab_size=int(store.vocab_size),
                   sid_length=int(store.sid_length))

    @classmethod
    def build(cls, obj) -> "CompressedSlab":
        """Compress a matrix or a store (stacked iff ``is_stacked``)."""
        return (cls.from_store(obj) if getattr(obj, "is_stacked", False)
                else cls.from_matrix(obj))

    @property
    def is_stacked(self) -> bool:
        return self.level_base.dim() == 2

    def base_for_step(self, step: int) -> torch.Tensor:
        """Next-state base at decode step ``step``: a 0-d int32 tensor, or a
        ``(K,)`` view of ``level_base`` when stacked (no copy)."""
        return self.level_base[..., step]

    def nbytes(self) -> int:
        return (self.tok_delta.numel() * self.tok_delta.element_size()
                + self.level_base.numel() * self.level_base.element_size())
