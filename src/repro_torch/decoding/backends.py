"""Constraint backends: STATIC over one :class:`TransitionMatrix` or a
stacked multi-tenant :class:`~repro_torch.constraints.ConstraintStore`, and
the paper's §5.2 baselines.

Counterparts of ``repro.decoding.backends``.  A backend masks one decode
step and reports, vocab-aligned, where each token emission leads
(DESIGN.md §3.1), or — on candidate-compressed levels — each beam's
dense-rank top-C ``(scores, tokens, next_states)`` (DESIGN.md §8).  The stacked backend keys every
lookup on per-row ``constraint_ids`` (DESIGN.md §4).  With a
delta-compressed ``slab`` (DESIGN.md §11) every sparse lookup reads the
slab's token deltas instead of the ``(token, next)`` pairs, with equal
outputs.  Over an all-sparse index (``dense_d == 0``) the STATIC backends
also mask rows at mixed decode levels in one call (``level_free_mask``,
the continuous engine's step, DESIGN.md §10).  The baseline backends mask
by each beam's emitted tokens (``prefix_tokens``, ``needs_prefix``) and
have no fused or candidate step.

``device`` is the device of the tables a backend holds, or ``None`` for
the host trie and the unconstrained step, which hold none.

``shardings(mesh, rows=...)`` gives the backend's placement on a process
mesh (DESIGN.md §6): the backend's own dataclass with a spec
(:mod:`repro_torch.distributed.sharding`) in place of every tensor.
``rows="replicated"`` replicates every table (paper §A.3); ``rows="model"``
row-shards the CSR ``edges`` slab, and the compressed ``tok_delta`` beside
it, along the mesh's ``model`` axis, for tries that outgrow one device
(:mod:`repro_torch.distributed.constraint_sharding`).  Backends without a
CSR replicate either way.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Protocol, runtime_checkable

import torch

from repro_torch.constraints.store import ConstraintStore
from repro_torch.core import dense_mask
from repro_torch.core.baselines import (
    CpuTrieBaseline,
    HashBitmapBaseline,
    PPVBaseline,
)
from repro_torch.core.compressed_slab import CompressedSlab
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.core.vntk import candidate_width
from repro_torch.kernels import ops as kernel_ops

__all__ = ["Impl", "Levels", "Rows", "ConstraintBackend", "BACKENDS",
           "StaticBackend", "StackedStaticBackend", "CpuTrieBackend",
           "PPVBackend", "HashBitmapBackend", "UnconstrainedBackend"]

# Which formulation runs the sparse levels: ``None`` (the CUDA kernels on a
# CUDA tensor, the plain versions on a CPU one) or ``"plain"``.  The
# reference's values are ``"xla"``/``"pallas"``.
Impl = Literal[kernel_ops.IMPLS]
Levels = Literal["auto", "dense", "sparse"]
Rows = Literal["replicated", "model"]


@runtime_checkable
class ConstraintBackend(Protocol):
    """Protocol every constraint backend implements (DESIGN.md §5), over
    torch tensors; ``repro.decoding.ConstraintBackend``'s contract.

    Static metadata (read by the policy, stable across hot swaps):
      * ``sid_length``       — SID length the backend was built for (``None``
                               for the unconstrained lower bound);
      * ``supports_fused``   — has a ``fused_step`` that folds the Phase-1
                               log-softmax into the masking pass;
      * ``supports_stacked`` — consumes per-row ``constraint_ids``;
      * ``needs_prefix``     — consumes the emitted-token history instead of
                               trie states;
      * ``supports_topk``    — has a candidate-compressed ``topk_step``
                               (DESIGN.md §8) emitting per-beam ``(scores,
                               tokens, next_states)`` of width ``C``;
                               ``topk_at(step)`` gates it per level.
                               Backends without it take the vocab-aligned
                               path in ``beam_search``.
    """

    sid_length: Optional[int]
    supports_fused: bool
    supports_stacked: bool
    needs_prefix: bool
    supports_topk: bool

    def mask_step(
        self,
        log_probs: torch.Tensor,  # (..., V) normalized log-probs
        nodes: torch.Tensor,  # (...,) int32 per-beam states
        step: int,  # decode level
        *,
        prefix_tokens: Optional[torch.Tensor] = None,  # (..., L) history
        constraint_ids: Optional[torch.Tensor] = None,  # (...,) int32 ids
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Phase 2 of Alg. 1: ``(masked_lp, next_dense)``, both
        vocab-aligned ``(..., V)``; ``next_dense[..., v] == 0`` iff emitting
        ``v`` is invalid."""
        ...

    def shardings(self, mesh, *, rows: Rows = "replicated"):
        """The backend with a spec in place of every tensor (DESIGN.md §6):
        ``rows="replicated"`` replicates every table (paper §A.3);
        ``rows="model"`` row-shards the CSR ``edges`` along the mesh's
        ``model`` axis.  Backends without a CSR replicate either way."""
        ...


def _check_rows(rows: str) -> None:
    if rows not in ("replicated", "model"):
        raise ValueError(
            f"rows must be 'replicated' or 'model', got {rows!r}")


def _replicated_specs(obj):
    """``obj`` with ``()`` (replicated) in place of every tensor, through
    nested dataclasses: the §A.3 default placement."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = ()
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _replicated_specs(v)
    return dataclasses.replace(obj, **changes) if changes else obj


def _static_specs(backend, field: str, mesh, rows: Rows, edges_spec,
                  delta_spec):
    """STATIC placement: replicated, or under ``rows="model"`` the CSR
    ``edges`` of ``backend.<field>`` (and the slab's ``tok_delta``) row-
    sharded over ``model``."""
    _check_rows(rows)
    specs = _replicated_specs(backend)
    if rows == "model" and "model" in mesh.mesh_dim_names:
        tables = dataclasses.replace(getattr(specs, field), edges=edges_spec)
        specs = dataclasses.replace(specs, **{field: tables})
        if backend.slab is not None:
            specs = dataclasses.replace(specs, slab=dataclasses.replace(
                specs.slab, tok_delta=delta_spec))
    return specs


def _check_step(step: int, sid_length: int) -> None:
    if step < 0 or step >= sid_length:
        raise ValueError(f"step {step} outside [0, {sid_length})")


def _reject_constraint_ids(constraint_ids, who: str) -> None:
    if constraint_ids is not None:
        raise ValueError(
            f"constraint_ids requires a stacked ConstraintStore backend, "
            f"got {who}")


def _dense_at(step: int, dense_d: int, levels: Levels,
              who: str = "StaticBackend") -> bool:
    """Route ``step`` to the dense bit-packed tables or the sparse VNTK."""
    dense = step < dense_d
    if levels == "dense" and not dense:
        raise ValueError(
            f"{who}(levels='dense') consulted at sparse step {step} "
            f"(dense_d={dense_d}); fix the policy plan")
    if levels == "sparse" and dense:
        raise ValueError(
            f"{who}(levels='sparse') consulted at dense step {step} "
            f"(dense_d={dense_d}); fix the policy plan")
    return dense


@dataclasses.dataclass(frozen=True)
class StaticBackend:
    """STATIC enforcement over one :class:`TransitionMatrix`.

    ``levels`` selects the band this instance serves: ``"dense"`` (steps <
    ``dense_d``), ``"sparse"`` (the VNTK for the rest) or ``"auto"``.
    ``impl`` is ``None`` (the CUDA kernels on a CUDA matrix, the plain
    versions on a CPU one) or ``"plain"`` (the plain versions on any device,
    to hold the kernels against them).  ``fused`` folds the log-softmax into
    the sparse step.  ``slab`` (optional) is the matrix's compressed edge
    slab: when present every sparse step goes through the compressed
    kernels.  ``tm.edges`` stays on the device beside it, as in the
    reference.
    """

    tm: TransitionMatrix
    slab: Optional[CompressedSlab] = None
    impl: Impl = None
    fused: bool = False
    levels: Levels = "auto"

    supports_fused = True
    supports_stacked = False
    needs_prefix = False
    supports_topk = True

    def __post_init__(self):
        if self.impl not in kernel_ops.IMPLS:
            raise ValueError(f"impl must be one of {kernel_ops.IMPLS}, got "
                             f"{self.impl!r}")

    @property
    def sid_length(self) -> int:
        return self.tm.sid_length

    @property
    def device(self) -> torch.device:
        return self.tm.device

    def topk_at(self, step: int) -> bool:
        """Candidate compression applies to the sparse (CSR) band only."""
        if self.levels == "dense":
            return False
        return step >= min(self.tm.dense_d, self.tm.sid_length)

    def candidate_width(self, beams: int) -> int:
        return candidate_width(beams, self.tm.vocab_size)

    def shardings(self, mesh, *, rows: Rows = "replicated"):
        return _static_specs(self, "tm", mesh, rows, ("model", None),
                             ("model",))

    def _bmax(self, step: int) -> int:
        return max(self.tm.bmax_for_step(step), 1)

    def mask_step(self, log_probs, nodes, step, *, prefix_tokens=None,
                  constraint_ids=None):
        """``(masked_lp, next_dense)``, both vocab-aligned ``(..., V)``."""
        _reject_constraint_ids(constraint_ids, "a single TransitionMatrix")
        _check_step(step, self.tm.sid_length)
        if _dense_at(step, self.tm.dense_d, self.levels):
            if step == 0:
                return dense_mask.dense_lookup_l0(log_probs, self.tm)
            return dense_mask.dense_lookup_l1(log_probs, nodes, self.tm)
        return self._sparse_mask(log_probs, nodes, step, fused=False)

    def _sparse_mask(self, values, nodes, step, *, fused):
        if self.slab is not None:
            return kernel_ops.vntk_compressed(
                values, nodes, self.tm.row_pointers, self.slab.tok_delta,
                self.slab.base_for_step(step), self._bmax(step),
                self.tm.vocab_size, impl=self.impl, fused_logsoftmax=fused)
        fn = kernel_ops.vntk_fused_logsoftmax if fused else kernel_ops.vntk
        return fn(values, nodes, self.tm.row_pointers, self.tm.edges,
                  self._bmax(step), self.tm.vocab_size, impl=self.impl)

    @property
    def supports_level_free(self) -> bool:
        """True when ONE mask call can serve rows at different decode
        levels (continuous batching): it needs an all-sparse index
        (``dense_d == 0``), so every level, the root included, resolves
        through the CSR and node ids are unique across levels.  The
        compressed slab opts out: its next states derive from a per-level
        base, so one call cannot serve mixed depths."""
        return (self.levels != "dense" and self.tm.dense_d == 0
                and self.slab is None)

    def level_free_mask(self, log_probs, nodes, *, constraint_ids=None):
        """Level-agnostic :meth:`mask_step`: rows may sit at different trie
        depths.  A row's admissible set is its node's CSR row; ``bmax``
        (the speculative burst's width) is the maximum over all levels and
        only sizes the burst, so the outputs equal the per-level call's at
        whatever level each node is on."""
        _reject_constraint_ids(constraint_ids, "a single TransitionMatrix")
        if not self.supports_level_free:
            raise ValueError(
                "level-free masking needs an all-sparse index (dense_d=0); "
                f"this StaticBackend has dense_d={self.tm.dense_d}, "
                f"levels={self.levels!r}, slab={self.slab is not None}")
        bmax = max(max(self.tm.bmax_for_step(s)
                       for s in range(self.tm.sid_length)), 1)
        return kernel_ops.vntk(log_probs, nodes, self.tm.row_pointers,
                               self.tm.edges, bmax, self.tm.vocab_size,
                               impl=self.impl)

    def fused_step(self, logits, nodes, step, *, prefix_tokens=None,
                   constraint_ids=None):
        """Phases 1-2 in one pass on sparse steps; dense steps normalize
        then look up."""
        _reject_constraint_ids(constraint_ids, "a single TransitionMatrix")
        _check_step(step, self.tm.sid_length)
        if _dense_at(step, self.tm.dense_d, self.levels):
            lp = torch.log_softmax(logits.float(), dim=-1)
            return self.mask_step(lp, nodes, step)
        return self._sparse_mask(logits, nodes, step, fused=True)

    def topk_step(self, values, nodes, step, width, *, constraint_ids=None,
                  normalized=True):
        """Per-beam dense-rank top-``width`` ``(scores, tokens, next)``;
        ``values`` are log-probs, or raw logits when not ``normalized``."""
        _reject_constraint_ids(constraint_ids, "a single TransitionMatrix")
        _check_step(step, self.tm.sid_length)
        if not self.topk_at(step):
            raise ValueError(
                f"StaticBackend(levels={self.levels!r}) has no candidate "
                f"row at dense step {step}; fix the policy plan")
        if self.slab is not None:
            return kernel_ops.vntk_compressed_topk(
                values, nodes, self.tm.row_pointers, self.slab.tok_delta,
                self.slab.base_for_step(step), self._bmax(step),
                self.tm.vocab_size, width, impl=self.impl,
                fused_logsoftmax=not normalized)
        return kernel_ops.vntk_topk(
            values, nodes, self.tm.row_pointers, self.tm.edges,
            self._bmax(step), self.tm.vocab_size, width,
            fused_logsoftmax=not normalized, impl=self.impl)


@dataclasses.dataclass(frozen=True)
class StackedStaticBackend:
    """STATIC over a stacked multi-tenant :class:`ConstraintStore`.

    Every lookup reads one extra leading constraint axis through the per-row
    ``constraint_ids``, which each step requires.  ``slab`` (the per-member
    compressed edge slab), ``impl``, ``fused`` and ``levels`` are as for
    :class:`StaticBackend`.
    """

    store: ConstraintStore
    slab: Optional[CompressedSlab] = None
    impl: Impl = None
    fused: bool = False
    levels: Levels = "auto"

    supports_fused = True
    supports_stacked = True
    needs_prefix = False
    supports_topk = True

    def __post_init__(self):
        if self.impl not in kernel_ops.IMPLS:
            raise ValueError(f"impl must be one of {kernel_ops.IMPLS}, got "
                             f"{self.impl!r}")

    @property
    def sid_length(self) -> int:
        return self.store.sid_length

    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def num_sets(self) -> int:
        return self.store.num_sets

    def topk_at(self, step: int) -> bool:
        if self.levels == "dense":
            return False
        return step >= min(self.store.dense_d, self.store.sid_length)

    def candidate_width(self, beams: int) -> int:
        return candidate_width(beams, self.store.vocab_size)

    def shardings(self, mesh, *, rows: Rows = "replicated"):
        return _static_specs(self, "store", mesh, rows,
                             (None, "model", None), (None, "model"))

    def _bmax(self, step: int) -> int:
        return max(self.store.bmax_for_step(step), 1)

    def _dense(self, step, constraint_ids) -> bool:
        """Check ids and step; True when ``step`` is a dense level."""
        self._require(step, constraint_ids)
        return _dense_at(step, self.store.dense_d, self.levels,
                         "StackedStaticBackend")

    def _require(self, step, constraint_ids) -> None:
        if constraint_ids is None:
            raise ValueError(
                "ConstraintStore lookups need per-row constraint_ids")
        _check_step(step, self.store.sid_length)

    def mask_step(self, log_probs, nodes, step, *, prefix_tokens=None,
                  constraint_ids=None):
        if self._dense(step, constraint_ids):
            if step == 0:
                return dense_mask.dense_lookup_l0(
                    log_probs, self.store, constraint_ids=constraint_ids)
            return dense_mask.dense_lookup_l1(
                log_probs, nodes, self.store, constraint_ids=constraint_ids)
        return self._sparse_mask(log_probs, nodes, step, constraint_ids,
                                 fused=False)

    def _sparse_mask(self, values, nodes, step, constraint_ids, *, fused):
        if self.slab is not None:
            return kernel_ops.vntk_compressed(
                values, nodes, self.store.row_pointers, self.slab.tok_delta,
                self.slab.base_for_step(step), self._bmax(step),
                self.store.vocab_size, impl=self.impl,
                constraint_ids=constraint_ids, fused_logsoftmax=fused)
        fn = kernel_ops.vntk_fused_logsoftmax if fused else kernel_ops.vntk
        return fn(values, nodes, self.store.row_pointers, self.store.edges,
                  self._bmax(step), self.store.vocab_size, impl=self.impl,
                  constraint_ids=constraint_ids)

    @property
    def supports_level_free(self) -> bool:
        """See :attr:`StaticBackend.supports_level_free`; the stacked
        variant keys every lookup on ``constraint_ids`` as well."""
        return (self.levels != "dense" and self.store.dense_d == 0
                and self.slab is None)

    def level_free_mask(self, log_probs, nodes, *, constraint_ids=None):
        """Level-agnostic stacked :meth:`mask_step` (see
        :meth:`StaticBackend.level_free_mask`)."""
        if constraint_ids is None:
            raise ValueError(
                "ConstraintStore lookups need per-row constraint_ids")
        if not self.supports_level_free:
            raise ValueError(
                "level-free masking needs an all-sparse index (dense_d=0); "
                f"this StackedStaticBackend has dense_d={self.store.dense_d}"
                f", levels={self.levels!r}, slab={self.slab is not None}")
        bmax = max(max(self.store.bmax_for_step(s)
                       for s in range(self.store.sid_length)), 1)
        return kernel_ops.vntk(log_probs, nodes, self.store.row_pointers,
                               self.store.edges, bmax, self.store.vocab_size,
                               impl=self.impl, constraint_ids=constraint_ids)

    def fused_step(self, logits, nodes, step, *, prefix_tokens=None,
                   constraint_ids=None):
        if self._dense(step, constraint_ids):
            lp = torch.log_softmax(logits.float(), dim=-1)
            return self.mask_step(lp, nodes, step,
                                  constraint_ids=constraint_ids)
        return self._sparse_mask(logits, nodes, step, constraint_ids,
                                 fused=True)

    def topk_step(self, values, nodes, step, width, *, constraint_ids=None,
                  normalized=True):
        """Candidate-compressed Phases 1-2 through the stacked store."""
        self._require(step, constraint_ids)
        if not self.topk_at(step):
            raise ValueError(
                f"StackedStaticBackend(levels={self.levels!r}) has no "
                f"candidate row at dense step {step}; fix the policy plan")
        if self.slab is not None:
            return kernel_ops.vntk_compressed_topk(
                values, nodes, self.store.row_pointers, self.slab.tok_delta,
                self.slab.base_for_step(step), self._bmax(step),
                self.store.vocab_size, width, impl=self.impl,
                constraint_ids=constraint_ids,
                fused_logsoftmax=not normalized)
        return kernel_ops.vntk_topk(
            values, nodes, self.store.row_pointers, self.store.edges,
            self._bmax(step), self.store.vocab_size, width,
            fused_logsoftmax=not normalized, impl=self.impl,
            constraint_ids=constraint_ids)


# ---------------------------------------------------------------------------
# Baseline backends: the prefix-token interface (paper §5.2)
# ---------------------------------------------------------------------------
def _require_prefix(prefix_tokens, who: str):
    if prefix_tokens is None:
        raise ValueError(
            f"{who} masks by emitted-token history; run it through a "
            "DecodePolicy-driven beam_search (which carries the prefix in "
            "its beam state) or pass prefix_tokens explicitly")


class _Baseline:
    """Flags and checks shared by the prefix-interface baselines."""

    supports_fused = False
    supports_stacked = False
    needs_prefix = True
    supports_topk = False

    def shardings(self, mesh, *, rows: Rows = "replicated"):
        """Replicated: the host trie has no device tables; the sorted SID
        tables are probed by binary search and the bitmap at random bits,
        so row-sharding would cost a cross-shard hop per probe."""
        _check_rows(rows)
        return _replicated_specs(self)

    def _checked(self, step, prefix_tokens, constraint_ids) -> None:
        who = type(self).__name__
        _reject_constraint_ids(constraint_ids, who)
        _require_prefix(prefix_tokens, who)
        _check_step(step, self.sid_length)


@dataclasses.dataclass(frozen=True)
class CpuTrieBackend(_Baseline):
    """The host pointer-chasing trie (Table 1 baseline): every step waits
    for a device-to-host-to-device round trip."""

    baseline: CpuTrieBaseline
    device = None  # the trie lives on the host

    @property
    def sid_length(self) -> int:
        return self.baseline.sid_length

    def mask_step(self, log_probs, nodes, step, *, prefix_tokens=None,
                  constraint_ids=None):
        self._checked(step, prefix_tokens, constraint_ids)
        return self.baseline.mask_step(log_probs, prefix_tokens, step)


@dataclasses.dataclass(frozen=True)
class PPVBackend(_Baseline, PPVBaseline):
    """DISC-PPV: a parallel binary search over the sorted SID table.

    Reuses :class:`PPVBaseline`'s search and verification over its tables:
    ``sids_sorted`` (N, L) int32 and ``keys`` (N, 4) int64 holding the
    packed uint32 lanes.
    """

    sids_sorted: torch.Tensor
    keys: torch.Tensor
    n: int
    vocab_size: int
    sid_length: int
    exact: bool
    top_k: int
    n_search_steps: int

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @classmethod
    def from_baseline(cls, b: PPVBaseline) -> "PPVBackend":
        return cls(sids_sorted=b.sids_sorted, keys=b.keys, n=b.n,
                   vocab_size=b.vocab_size, sid_length=b.sid_length,
                   exact=b.exact, top_k=b.top_k,
                   n_search_steps=b.n_search_steps)

    @classmethod
    def from_sids(cls, sids, vocab_size: int, *, exact: bool = True,
                  top_k: int = 50, device=None) -> "PPVBackend":
        return cls.from_baseline(PPVBaseline(sids, vocab_size, exact=exact,
                                             top_k=top_k, device=device))

    def mask_step(self, log_probs, nodes, step, *, prefix_tokens=None,
                  constraint_ids=None):
        self._checked(step, prefix_tokens, constraint_ids)
        return PPVBaseline.mask_step(self, log_probs, prefix_tokens, step)


@dataclasses.dataclass(frozen=True)
class HashBitmapBackend(_Baseline, HashBitmapBaseline):
    """Bloom-style hashed-prefix bitmap (constant time, false positives);
    ``bitmap`` is the ``(2^log2_bits / 8,)`` uint8 table."""

    bitmap: torch.Tensor
    vocab_size: int
    sid_length: int
    log2_bits: int

    @property
    def device(self) -> torch.device:
        return self.bitmap.device

    @classmethod
    def from_baseline(cls, b: HashBitmapBaseline) -> "HashBitmapBackend":
        return cls(bitmap=b.bitmap, vocab_size=b.vocab_size,
                   sid_length=b.sid_length, log2_bits=b.log2_bits)

    @classmethod
    def from_sids(cls, sids, vocab_size: int, *, log2_bits: int = 27,
                  device=None) -> "HashBitmapBackend":
        return cls.from_baseline(HashBitmapBaseline(
            sids, vocab_size, log2_bits=log2_bits, device=device))

    def mask_step(self, log_probs, nodes, step, *, prefix_tokens=None,
                  constraint_ids=None):
        self._checked(step, prefix_tokens, constraint_ids)
        return HashBitmapBaseline.mask_step(self, log_probs, prefix_tokens,
                                            step)


@dataclasses.dataclass(frozen=True)
class UnconstrainedBackend:
    """No validity check at all: the latency lower bound of Table 1."""

    supports_fused = False
    supports_stacked = False
    needs_prefix = False
    supports_topk = False
    sid_length = None
    device = None

    def shardings(self, mesh, *, rows: Rows = "replicated"):
        _check_rows(rows)
        return self

    def mask_step(self, log_probs, nodes, step, *, prefix_tokens=None,
                  constraint_ids=None):
        _reject_constraint_ids(constraint_ids, "UnconstrainedBackend")
        # every token is valid; beams stay parked at the root state
        return log_probs, torch.ones(log_probs.shape, dtype=torch.int32,
                                     device=log_probs.device)


BACKENDS = (StaticBackend, StackedStaticBackend, CpuTrieBackend, PPVBackend,
            HashBitmapBackend, UnconstrainedBackend)
