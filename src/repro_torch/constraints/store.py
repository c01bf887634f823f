"""Stacked multi-constraint transition store (DESIGN.md §4).

Counterpart of ``repro.constraints.store``: ``ConstraintStore`` packs K
:class:`~repro_torch.core.TransitionMatrix` members (same vocab, SID length
and dense depth) into torch tensors with a leading constraint axis, so one
beam-search batch serves each row under its own constraint set through a
per-row ``constraint_ids`` vector.

Capacity envelope: members are padded to common ``n_states`` / ``n_edges``
sizes, optionally with *headroom*, so a refreshed member can be swapped into
a slot (``with_member``) without changing any tensor shape or static field.
Padded states have empty CSR rows (they behave as the sink) and padded edges
are zeros, which the valid-length mask of Alg. 2 ignores, so padding never
changes a lookup.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.core.trie import check_index_capacity

__all__ = ["ConstraintStore", "EnvelopeOverflow"]

_TABLE_FIELDS = ("row_pointers", "edges", "l0_mask_packed", "l0_states",
                 "l1_mask_packed", "l1_states")
_LEAF_FIELDS = _TABLE_FIELDS + ("member_n_states", "member_n_edges",
                                "member_n_constraints")


class EnvelopeOverflow(ValueError):
    """A refreshed matrix does not fit the store's capacity envelope."""


def _edge_pad(bmax: int) -> int:
    """Speculative-slice safety pad (same formula as the trie builder)."""
    return -int(bmax) % 128 + int(bmax) + 128


def _edge_capacity(n_edges: int, bmax_max: int) -> int:
    """Edge rows needed to hold ``n_edges`` real edges under ``bmax_max``:
    a speculative slice of any branch factor ``<= bmax_max`` starting at the
    final real edge stays in bounds.  ``from_matrices`` sizes the envelope
    with it and ``_check_fits`` validates swaps against it."""
    return int(n_edges) + _edge_pad(bmax_max)


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _counts(values, device) -> torch.Tensor:
    return torch.tensor([int(v) for v in values], dtype=torch.int32,
                        device=device)


@dataclasses.dataclass(frozen=True)
class ConstraintStore:
    """K padded :class:`TransitionMatrix` members stacked on a leading axis."""

    row_pointers: torch.Tensor  # (K, n_states + 1) int32
    edges: torch.Tensor  # (K, n_edges, 2) int32 stacked [token, next_state]
    l0_mask_packed: torch.Tensor  # (K, ceil(V/8)) uint8
    l0_states: torch.Tensor  # (K, V) int32
    l1_mask_packed: torch.Tensor  # (K, V, ceil(V/8)) uint8 (or (K, 1, 1))
    l1_states: torch.Tensor  # (K, V, V) int32 (or (K, 1, 1))
    member_n_states: torch.Tensor  # (K,) int32 real state counts
    member_n_edges: torch.Tensor  # (K,) int32 real edge counts
    member_n_constraints: torch.Tensor  # (K,) int32 SIDs per member
    # static fields: fixed across hot swaps
    vocab_size: int
    sid_length: int
    dense_d: int
    level_bmax: tuple
    n_states: int
    n_edges: int
    num_sets: int

    # ------------------------------------------------------------------
    @classmethod
    def from_matrices(cls, mats: Sequence[TransitionMatrix], *,
                      headroom: float = 0.0, device=None) -> "ConstraintStore":
        """Stack matrices into one store on ``device``, padded to a common
        envelope.  ``headroom`` (a fraction, e.g. 0.5) over-allocates the
        state/edge/branch-factor envelope so later hot swaps of larger
        members still fit."""
        mats = list(mats)
        if not mats:
            raise ValueError("ConstraintStore needs at least one matrix")
        if headroom < 0:
            raise ValueError("headroom must be >= 0")
        ref = mats[0]
        for i, m in enumerate(mats):
            for f in ("vocab_size", "sid_length", "dense_d"):
                if getattr(m, f) != getattr(ref, f):
                    raise ValueError(
                        f"matrix {i}: {f}={getattr(m, f)} != {getattr(ref, f)}"
                        " — all members must share vocab/sid_length/dense_d")
            if m.l1_mask_packed.shape != ref.l1_mask_packed.shape:
                raise ValueError(f"matrix {i}: inconsistent dense-l1 tables")

        grow = 1.0 + headroom
        bmax_env = tuple(
            int(np.ceil(max(m.level_bmax[l] for m in mats) * grow))
            for l in range(ref.sid_length))
        n_states_env = int(np.ceil(max(m.n_states for m in mats) * grow))
        e_real = max(m.n_edges for m in mats)
        n_edges_env = max(
            _edge_capacity(int(np.ceil(e_real * grow)), max(max(bmax_env), 1)),
            max(m.edges.shape[0] for m in mats))
        check_index_capacity(
            _numpy_dtype(ref.row_pointers), n_states=n_states_env,
            n_edge_rows=n_edges_env, vocab_size=ref.vocab_size)
        dev = resolve_device(device)
        return cls(
            **_stack(mats, n_states_env, n_edges_env, dev),
            member_n_states=_counts([m.n_states for m in mats], dev),
            member_n_edges=_counts([m.n_edges for m in mats], dev),
            member_n_constraints=_counts([m.n_constraints for m in mats], dev),
            vocab_size=ref.vocab_size, sid_length=ref.sid_length,
            dense_d=ref.dense_d, level_bmax=bmax_env, n_states=n_states_env,
            n_edges=n_edges_env, num_sets=len(mats))

    @classmethod
    def from_numpy(cls, arrays: dict, meta: dict, device=None) -> "ConstraintStore":
        """Build from host arrays (every tensor field) and the static fields."""
        dev = resolve_device(device)
        return cls(**{f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(dev)
                      for f in _LEAF_FIELDS}, **meta)

    # ------------------------------------------------------------------
    @property
    def is_stacked(self) -> bool:
        """K constraint sets on a leading axis; lookups need per-row ids."""
        return True

    @property
    def device(self) -> torch.device:
        return self.row_pointers.device

    def to(self, device=None) -> "ConstraintStore":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in _LEAF_FIELDS})

    def bmax_for_step(self, step: int) -> int:
        """Envelope branch factor at ``step`` (max over members + headroom)."""
        return int(self.level_bmax[step])

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in _LEAF_FIELDS)

    # ------------------------------------------------------------------
    def member(self, k: int) -> TransitionMatrix:
        """Set ``k`` as a standalone matrix: views of the store's padded
        tensors (envelope shapes and ``level_bmax``) with the member's REAL
        counts, so lookups equal the original member's and
        ``with_member(k, member(k))`` always fits the envelope."""
        if not 0 <= k < self.num_sets:
            raise IndexError(f"constraint set {k} outside [0, {self.num_sets})")
        return TransitionMatrix(
            **{f: getattr(self, f)[k] for f in _TABLE_FIELDS},
            vocab_size=self.vocab_size, sid_length=self.sid_length,
            dense_d=self.dense_d, level_bmax=self.level_bmax,
            n_states=int(self.member_n_states[k]),
            n_edges=int(self.member_n_edges[k]),
            n_constraints=int(self.member_n_constraints[k]))

    def _check_fits(self, tm: TransitionMatrix) -> None:
        """Raise :class:`EnvelopeOverflow` unless ``tm`` fits the envelope."""
        for f in ("vocab_size", "sid_length", "dense_d"):
            if getattr(tm, f) != getattr(self, f):
                raise ValueError(
                    f"hot-swap {f} mismatch: {getattr(tm, f)} != {getattr(self, f)}")
        if tm.n_states > self.n_states:
            raise EnvelopeOverflow(
                f"hot-swap needs {tm.n_states} states but envelope holds "
                f"{self.n_states}; rebuild the store with more headroom")
        needed_edges = max(_edge_capacity(tm.n_edges, max(self.level_bmax)),
                           tm.edges.shape[0])
        if needed_edges > self.n_edges:
            raise EnvelopeOverflow(
                f"hot-swap needs {needed_edges} edge rows but envelope holds "
                f"{self.n_edges}; rebuild the store with more headroom")
        for l, (b_new, b_env) in enumerate(zip(tm.level_bmax, self.level_bmax)):
            if b_new > b_env:
                raise EnvelopeOverflow(
                    f"hot-swap level-{l} branch factor {b_new} exceeds "
                    f"envelope {b_env}; rebuild the store with more headroom")

    def with_member(self, k: int, tm: TransitionMatrix) -> "ConstraintStore":
        """Functional hot swap: a new store with ``tm`` in slot ``k``.

        Every shape and static field is kept.  The store a reader holds is
        never written: each table is copied and the copy's slot ``k``
        replaced, so during a swap the device holds two copies of the store
        until the old one is dropped.
        """
        if not 0 <= k < self.num_sets:
            raise IndexError(f"constraint set {k} outside [0, {self.num_sets})")
        self._check_fits(tm)
        updates = {}
        for name in _TABLE_FIELDS:
            new = getattr(self, name).clone()
            _pad_member(tm, name, self.n_states, self.n_edges, new[k])
            updates[name] = new
        for name, value in (("member_n_states", tm.n_states),
                            ("member_n_edges", tm.n_edges),
                            ("member_n_constraints", tm.n_constraints)):
            updates[name] = getattr(self, name).clone()
            updates[name][k] = int(value)
        return dataclasses.replace(self, **updates)

    def with_members(self, mats: Sequence[TransitionMatrix]) -> "ConstraintStore":
        """Hot-swap every slot at once: all members are validated first, then
        one new set of tables is built (one store copy, not K)."""
        mats = list(mats)
        if len(mats) != self.num_sets:
            raise ValueError(
                f"with_members needs {self.num_sets} matrices, got {len(mats)}")
        for tm in mats:
            self._check_fits(tm)
        dev = self.device
        return dataclasses.replace(
            self, **_stack(mats, self.n_states, self.n_edges, dev),
            member_n_states=_counts([m.n_states for m in mats], dev),
            member_n_edges=_counts([m.n_edges for m in mats], dev),
            member_n_constraints=_counts([m.n_constraints for m in mats], dev))

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """The reference's npz layout: every tensor field, ``meta = [V, L,
        dense_d, n_states, n_edges, num_sets]`` and ``level_bmax``."""
        np.savez_compressed(
            path,
            **{f: getattr(self, f).cpu().numpy() for f in _LEAF_FIELDS},
            meta=np.array([self.vocab_size, self.sid_length, self.dense_d,
                           self.n_states, self.n_edges, self.num_sets],
                          dtype=np.int64),
            level_bmax=np.asarray(self.level_bmax, dtype=np.int64))

    @classmethod
    def load(cls, path: str, device=None) -> "ConstraintStore":
        with np.load(path) as z:
            meta = z["meta"]
            return cls.from_numpy(
                {f: z[f] for f in _LEAF_FIELDS},
                dict(vocab_size=int(meta[0]), sid_length=int(meta[1]),
                     dense_d=int(meta[2]),
                     level_bmax=tuple(int(b) for b in z["level_bmax"]),
                     n_states=int(meta[3]), n_edges=int(meta[4]),
                     num_sets=int(meta[5])),
                device)


def _stack(mats, n_states: int, n_edges: int, device) -> dict:
    """The stacked tables of ``mats`` padded to the envelope, allocated on
    ``device`` and filled member by member (no host-side stack); dtypes
    promote across members as ``np.stack`` does."""
    out = {}
    for name in _TABLE_FIELDS:
        first = getattr(mats[0], name)
        if name == "row_pointers":
            shape = (n_states + 1,)
        elif name == "edges":
            shape = (n_edges, 2)
        else:
            shape = tuple(first.shape)
        dtype = functools.reduce(torch.promote_types,
                                 [getattr(m, name).dtype for m in mats])
        t = torch.empty((len(mats),) + shape, dtype=dtype, device=device)
        for k, m in enumerate(mats):
            _pad_member(m, name, n_states, n_edges, t[k])
        out[name] = t
    return out


# Host tables cross to the card through two pinned staging buffers of this
# many bytes each: the host fills one while the other's copy runs.
_STAGE_BYTES = 64 << 20


def _upload(out: torch.Tensor, a: torch.Tensor) -> None:
    """``out.copy_(a)``, ``out`` contiguous on the card and ``a`` on the
    host: chunk by chunk through two pinned staging buffers (converted to
    ``out``'s dtype on the host), each chunk's copy ``non_blocking`` on the
    current stream.  The host refills a buffer only after the event of its
    last copy, so it waits on its own copies, never on the device as a
    whole, and makes no pageable copy: pageable copies of a store's tables
    stalled the serving rounds that met them several-fold on the card."""
    src, dst = a.reshape(-1), out.view(-1)
    n, stream = src.numel(), torch.cuda.current_stream(out.device)
    step = max(1, _STAGE_BYTES // out.element_size())
    bufs = [torch.empty(min(step, n), dtype=out.dtype, pin_memory=True)
            for _ in range(min(2, -(-n // step)))]
    copied = [None] * len(bufs)
    for i, off in enumerate(range(0, n, step)):
        b, m = i % len(bufs), min(step, n - off)
        if copied[b] is not None:
            copied[b].synchronize()
        bufs[b][:m].copy_(src[off:off + m])
        dst[off:off + m].copy_(bufs[b][:m], non_blocking=True)
        copied[b] = torch.cuda.Event()
        copied[b].record(stream)


def _pad_member(tm: TransitionMatrix, name: str, n_states: int, n_edges: int,
                out: torch.Tensor) -> None:
    """Write one member table, padded to the envelope, into ``out``.

    A member on another device (a registry keeps its matrices on the host)
    is copied straight into ``out``, with no temporary on ``out``'s device;
    from the host to the card through pinned staging (:func:`_upload`).
    """
    a = getattr(tm, name)
    staged = a.device.type == "cpu" and out.device.type == "cuda"
    copy = _upload if staged else torch.Tensor.copy_
    if name == "row_pointers":
        # padded states get empty CSR rows: repeat the final pointer
        copy(out[: tm.n_states + 1], a[: tm.n_states + 1])
        out[tm.n_states + 1:] = out[tm.n_states]
    elif name == "edges":
        copy(out[: a.shape[0]], a)
        out[a.shape[0]:] = 0
    else:  # dense tables are fixed-shape given (V, dense_d)
        copy(out, a)
