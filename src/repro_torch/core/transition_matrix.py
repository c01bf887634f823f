"""Device-resident sparse transition matrix (paper §4.2-4.3).

A container of torch tensors (stacked CSR + dense bit-packed prefix masks)
and the static metadata the decode steps specialise on.  ``save``/``load``
read and write the reference's npz format (``repro.core.transition_matrix``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import trie as trie_lib

__all__ = ["TransitionMatrix", "ROOT_STATE", "SINK_STATE"]

SINK_STATE = 0
ROOT_STATE = 1

_TENSOR_FIELDS = ("row_pointers", "edges", "l0_mask_packed", "l0_states",
                  "l1_mask_packed", "l1_states")


@dataclasses.dataclass(frozen=True)
class TransitionMatrix:
    """CSR-based transition matrix with the dense-level tables."""

    row_pointers: torch.Tensor  # (n_states + 1,) int32
    edges: torch.Tensor  # (n_edges + pad, 2) int32 stacked [token, next_state]
    l0_mask_packed: torch.Tensor  # (ceil(V/8),) uint8 (all-ones if dense_d == 0)
    l0_states: torch.Tensor  # (V,) int32
    l1_mask_packed: torch.Tensor  # (V, ceil(V/8)) uint8 (or (1,1) dummy)
    l1_states: torch.Tensor  # (V, V) int32 (or (1,1) dummy)
    vocab_size: int
    sid_length: int
    dense_d: int
    level_bmax: tuple
    n_states: int
    n_edges: int
    n_constraints: int

    # ------------------------------------------------------------------
    @classmethod
    def from_numpy(cls, arrays: dict, meta: dict, device=None) -> "TransitionMatrix":
        """Build from host arrays (keys of ``_TENSOR_FIELDS``) and metadata."""
        dev = resolve_device(device)
        tensors = {f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(dev)
                   for f in _TENSOR_FIELDS}
        return cls(**tensors, **meta)

    @classmethod
    def from_flat_trie(cls, ft: trie_lib.FlatTrie, device=None) -> "TransitionMatrix":
        V = ft.vocab_size
        idx_dt = ft.row_pointers.dtype
        arrays = dict(row_pointers=ft.row_pointers, edges=ft.edges)
        if ft.l0_mask_packed is not None:
            arrays.update(l0_mask_packed=ft.l0_mask_packed, l0_states=ft.l0_states)
        else:
            arrays.update(l0_mask_packed=np.full(((V + 7) // 8,), 0xFF, np.uint8),
                          l0_states=np.zeros((V,), idx_dt))
        if ft.l1_mask_packed is not None:
            arrays.update(l1_mask_packed=ft.l1_mask_packed, l1_states=ft.l1_states)
        else:
            arrays.update(l1_mask_packed=np.zeros((1, 1), np.uint8),
                          l1_states=np.zeros((1, 1), idx_dt))
        meta = dict(
            vocab_size=V, sid_length=ft.sid_length, dense_d=ft.dense_d,
            level_bmax=tuple(int(b) for b in ft.level_bmax),
            n_states=int(ft.n_states), n_edges=int(ft.n_edges),
            n_constraints=int(ft.n_constraints),
        )
        return cls.from_numpy(arrays, meta, device)

    @classmethod
    def from_sids(cls, sids: np.ndarray, vocab_size: int, dense_d: int = 2,
                  device=None) -> "TransitionMatrix":
        """Offline construction: restricted vocabulary -> flattened trie."""
        return cls.from_flat_trie(
            trie_lib.build_flat_trie(sids, vocab_size, dense_d=dense_d), device)

    # ------------------------------------------------------------------
    @property
    def is_stacked(self) -> bool:
        """Single constraint set (a ConstraintStore reports ``True``)."""
        return False

    @property
    def device(self) -> torch.device:
        return self.row_pointers.device

    def to(self, device=None) -> "TransitionMatrix":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in _TENSOR_FIELDS})

    def bmax_for_step(self, step: int) -> int:
        """Max branch factor consulted at decode step ``step``."""
        return int(self.level_bmax[step])

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in _TENSOR_FIELDS)

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            **{f: getattr(self, f).cpu().numpy() for f in _TENSOR_FIELDS},
            meta=np.array(
                [self.vocab_size, self.sid_length, self.dense_d, self.n_states,
                 self.n_edges, self.n_constraints], dtype=np.int64),
            level_bmax=np.asarray(self.level_bmax, dtype=np.int64),
        )

    @classmethod
    def load(cls, path: str, device=None) -> "TransitionMatrix":
        with np.load(path) as z:
            meta = z["meta"]
            return cls.from_numpy(
                {f: z[f] for f in _TENSOR_FIELDS},
                dict(vocab_size=int(meta[0]), sid_length=int(meta[1]),
                     dense_d=int(meta[2]),
                     level_bmax=tuple(int(b) for b in z["level_bmax"]),
                     n_states=int(meta[3]), n_edges=int(meta[4]),
                     n_constraints=int(meta[5])),
                device)
