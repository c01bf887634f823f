"""DecodePolicy — a per-level constraint plan for beam decoding.

Counterpart of ``repro.decoding.policy.DecodePolicy``: it binds which
backend masks each decode level (STATIC over one matrix or a stacked
multi-tenant store, or one of the paper's §5.2 baselines) and normalizes
Phase 1 (log-softmax) unless the backend fuses it.  Over an all-sparse index it also masks rows at mixed
decode levels in one call, sharing mask rows across beams on one trie node
(the continuous engine's step, DESIGN.md §10).  Per-row ``constraint_ids``
reach only the backends that read a stacked store, and the emitted tokens
(``prefix_tokens``) the baselines that mask by them.  ``shardings`` places
the policy on a process mesh (DESIGN.md §6).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.constraints.store import ConstraintStore
from repro_torch.core.baselines import (
    CpuTrieBaseline,
    HashBitmapBaseline,
    PPVBaseline,
)
from repro_torch.core.compressed_slab import CompressedSlab
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.core.vntk import NEG_INF
from repro_torch.decoding.backends import (
    BACKENDS,
    CpuTrieBackend,
    HashBitmapBackend,
    Impl,
    PPVBackend,
    StackedStaticBackend,
    StaticBackend,
    UnconstrainedBackend,
)

__all__ = ["DecodePolicy", "as_policy"]


@dataclasses.dataclass(frozen=True)
class DecodePolicy:
    """Per-level backend plan: ``backends[plan[step]]`` masks ``step``.

    Steps beyond ``len(plan)`` reuse the final entry (relevant only for the
    unconstrained policy, whose length is unbounded).  ``candidate_topk``
    runs every level whose backend supports it through the
    candidate-compressed step (DESIGN.md §8).
    """

    backends: tuple
    plan: tuple
    candidate_topk: bool = True

    def __post_init__(self):
        if not self.backends:
            raise ValueError("DecodePolicy needs at least one backend")
        if not self.plan:
            raise ValueError("DecodePolicy needs a non-empty plan")
        bad = [i for i in self.plan if not 0 <= i < len(self.backends)]
        if bad:
            raise ValueError(f"plan references unknown backends: {bad}")

    def backend_for(self, step: int):
        return self.backends[self.plan[min(step, len(self.plan) - 1)]]

    @property
    def sid_length(self) -> Optional[int]:
        for b in self.backends:
            if b.sid_length is not None:
                return b.sid_length
        return None

    @property
    def is_constrained(self) -> bool:
        return any(not isinstance(b, UnconstrainedBackend)
                   for b in self.backends)

    @property
    def requires_constraint_ids(self) -> bool:
        return any(b.supports_stacked for b in self.backends)

    @property
    def needs_prefix(self) -> bool:
        return any(b.needs_prefix for b in self.backends)

    @property
    def device(self) -> Optional[torch.device]:
        """The device of the first tables the policy holds, or ``None`` when
        it holds none (the host trie, the unconstrained step)."""
        for b in self.backends:
            if b.device is not None:
                return b.device
        return None

    @property
    def num_sets(self) -> Optional[int]:
        """Member count of the stacked store, or ``None`` if single-tenant."""
        for b in self.backends:
            if b.supports_stacked:
                return b.num_sets
        return None

    @property
    def constraints(self):
        """The underlying TransitionMatrix or ConstraintStore, or ``None``
        when no STATIC backend is present."""
        for b in self.backends:
            if isinstance(b, StackedStaticBackend):
                return b.store
            if isinstance(b, StaticBackend):
                return b.tm
        return None

    def shardings(self, mesh, *, rows: str = "replicated") -> "DecodePolicy":
        """The policy with every backend replaced by its ``shardings`` spec
        tree (DESIGN.md §6): the same structure, static fields kept, a spec
        in place of every tensor."""
        return dataclasses.replace(self, backends=tuple(
            b.shardings(mesh, rows=rows) for b in self.backends))

    def _ids_for(self, b, constraint_ids):
        """The ids a backend takes: only stacked backends read them."""
        if constraint_ids is not None and not self.requires_constraint_ids:
            raise ValueError(
                "constraint_ids requires a stacked ConstraintStore policy")
        return constraint_ids if b.supports_stacked else None

    # -- candidate-compressed decoding (DESIGN.md §8) ----------------------
    def supports_topk_at(self, step: int) -> bool:
        """True iff decode level ``step`` runs the candidate-compressed path."""
        if not self.candidate_topk:
            return False
        b = self.backend_for(step)
        return bool(b.supports_topk and b.topk_at(step))

    def candidate_width(self, beams: int, step: int) -> int:
        """Per-beam candidate count ``C`` for ``step``."""
        return self.backend_for(step).candidate_width(beams)

    def with_topk(self, enabled: bool) -> "DecodePolicy":
        return dataclasses.replace(self, candidate_topk=bool(enabled))

    def step_topk(self, logits, nodes, step: int, width: int, *,
                  constraint_ids=None, normalized: bool = False):
        """Candidate-compressed Phases 1-2: per-beam dense-rank top-``width``
        ``(scores, tokens, next_states)``, each ``(..., width)`` — the
        top-``width`` of the row :meth:`step` would produce, in its flat-index
        tie order."""
        if not self.supports_topk_at(step):
            raise ValueError(
                f"step {step} has no candidate-compressed backend "
                f"(plan {self.describe()}); use step() or check "
                "supports_topk_at first")
        b = self.backend_for(step)
        cids = self._ids_for(b, constraint_ids)
        if not normalized and b.fused:
            return b.topk_step(logits, nodes, step, width,
                               constraint_ids=cids, normalized=False)
        lp = logits if normalized else torch.log_softmax(logits.float(), dim=-1)
        return b.topk_step(lp, nodes, step, width, constraint_ids=cids,
                           normalized=True)

    def step(self, logits, nodes, step: int, *, prefix_tokens=None,
             constraint_ids=None, normalized: bool = False):
        """Phases 1-2 of Alg. 1: ``(masked_log_probs, next_dense)``, both
        vocab-aligned.  ``prefix_tokens`` (..., L) are the beams' emitted
        tokens, which the baselines mask by."""
        b = self.backend_for(step)
        if b.needs_prefix and prefix_tokens is None:
            raise ValueError(
                f"{type(b).__name__} needs prefix_tokens at step {step}")
        cids = self._ids_for(b, constraint_ids)
        if not normalized and getattr(b, "fused", False):
            return b.fused_step(logits, nodes, step,
                                prefix_tokens=prefix_tokens,
                                constraint_ids=cids)
        lp = logits if normalized else torch.log_softmax(logits.float(), dim=-1)
        return b.mask_step(lp, nodes, step, prefix_tokens=prefix_tokens,
                           constraint_ids=cids)

    # -- level-free masking (continuous batching, DESIGN.md §10) -----------
    @property
    def supports_level_free(self) -> bool:
        """True when one mask call serves rows at different decode levels: a
        single-backend plan whose backend is all-sparse (``dense_d == 0``,
        so node ids are unique across levels and ``(constraint_id, node)``
        alone determines the admissible set)."""
        if len(set(self.plan)) != 1:
            return False
        return bool(getattr(self.backends[self.plan[0]],
                            "supports_level_free", False))

    def _level_free(self, constraint_ids):
        """The backend and the ids it takes; raises unless level-free."""
        if not self.supports_level_free:
            raise ValueError(
                f"[{self.describe()}] cannot mask level-free; build the "
                "policy over a dense_d=0 index "
                "(TransitionMatrix.from_sids(..., dense_d=0))")
        b = self.backends[self.plan[0]]
        return b, self._ids_for(b, constraint_ids)

    def level_free_step(self, logits, nodes, *, constraint_ids=None,
                        normalized: bool = False):
        """Phases 1-2 with per-row levels: ``(masked_log_probs, next_dense)``
        for ``logits`` (N, V) and ``nodes`` (N,) at ANY mixture of levels.

        Equal to :meth:`step` at whatever level each row's node sits on.
        Always normalizes, then masks: the fused kernel is per-level and
        is not consulted.
        """
        b, cids = self._level_free(constraint_ids)
        lp = logits if normalized else torch.log_softmax(logits.float(), dim=-1)
        return b.level_free_mask(lp, nodes, constraint_ids=cids)

    def shared_mask_step(self, logits, nodes, *, constraint_ids=None,
                         share_width: Optional[int] = None,
                         normalized: bool = False):
        """Trie-prefix-shared Phases 1-2: rows with equal ``(constraint_id,
        node)`` (beams on the same trie node) compute ONE mask and
        next-state row instead of one each.

        Returns ``(masked_log_probs, next_dense, n_unique)``, ``n_unique`` a
        0-d tensor on the rows' device (``N - n_unique`` mask rows saved).
        The mask and next-state rows are functions of the key alone, so the
        sharing is exact: the mask row is made once from zero log-probs
        (its entries are then ``0.0`` on admissible tokens and ``NEG_INF``
        elsewhere) and applied to each row by a select, which gives the
        bits of masking every row on its own.

        ``share_width`` caps the representative rows ``U``.  With ``U >=
        N`` (or ``None``) the shared branch always runs and nothing waits
        for the device.  With ``U < N`` a step whose rows hold more than
        ``U`` keys masks every row on its own instead; that choice is the
        reference's ``lax.cond``, taken here on the host, so it reads
        ``n_unique`` back: **one device-to-host sync per call**, after
        everything queued before it.  Both branches give the same bits.
        """
        b, cids = self._level_free(constraint_ids)
        lp = logits if normalized else torch.log_softmax(logits.float(), dim=-1)
        N, V = lp.shape
        keys = nodes.long()
        if cids is not None:  # int64: K * (n_states + 1) may pass 2^31
            keys = cids.long() * (self.constraints.n_states + 1) + keys
        order = torch.argsort(keys, stable=True)  # any representative works
        sorted_keys = keys[order]
        new_key = torch.ones(N, dtype=torch.bool, device=lp.device)
        new_key[1:] = sorted_keys[1:] != sorted_keys[:-1]
        uid_sorted = torch.cumsum(new_key, 0) - 1  # (N,) int64
        n_unique = uid_sorted[-1] + 1
        U = N if share_width is None else int(share_width)
        if U < N and int(n_unique) > U:  # the host sync
            masked, nxt = b.level_free_mask(lp, nodes, constraint_ids=cids)
            return masked, nxt, n_unique
        inv = torch.empty_like(uid_sorted).scatter_(0, order, uid_sorted)
        # one source row per key (U - n_unique slots stay on row 0)
        rep_src = torch.zeros(U, dtype=torch.int64, device=lp.device)
        rep_src.scatter_(0, uid_sorted, order)
        mask_rows, next_rows = b.level_free_mask(
            torch.zeros((U, V), dtype=lp.dtype, device=lp.device),
            nodes[rep_src],
            constraint_ids=None if cids is None else cids[rep_src])
        masked = torch.where(mask_rows[inv] == 0.0, lp, NEG_INF)
        return masked, next_rows[inv], n_unique

    def plan_info(self, beams: int = 1) -> list:
        """Machine-readable per-level plan for telemetry (DESIGN.md §9): one
        dict per level of ``plan`` with the backend masking it, whether the
        level is sparse, whether it takes the candidate-compressed branch,
        and the per-beam top-C width for ``beams`` there (0 otherwise).
        Static metadata, unchanged by a hot swap."""
        rows = []
        for step in range(len(self.plan)):
            b = self.backend_for(step)
            topk = self.supports_topk_at(step)
            rows.append(dict(
                level=step,
                backend=type(b).__name__.replace("Backend", "").lower(),
                sparse=getattr(b, "levels", None) != "dense",
                topk=topk,
                candidate_width=(self.candidate_width(beams, step)
                                 if topk else 0),
            ))
        return rows

    def describe(self) -> str:
        """Human-readable per-level plan, e.g. ``L0-1:dense-bitpack
        L2-7:vntk[auto+topk]`` (``auto``: kernel on the card, plain on
        the CPU; ``+slab``: the compressed edge slab); stacked backends read
        ``stacked(K=...):...``, baselines their backend's name
        (``ppv``, ``cputrie``, ``hashbitmap``, ``unconstrained``)."""
        def label(b):
            if not isinstance(b, (StaticBackend, StackedStaticBackend)):
                return type(b).__name__.replace("Backend", "").lower()
            kind = "dense-bitpack" if b.levels == "dense" else (
                f"vntk[{b.impl or 'auto'}{'+fused' if b.fused else ''}"
                f"{'+topk' if self.candidate_topk else ''}"
                f"{'+slab' if b.slab is not None else ''}]")
            if isinstance(b, StackedStaticBackend):
                return f"stacked(K={b.num_sets}):{kind}"
            return kind

        parts, start = [], 0
        for s in range(1, len(self.plan) + 1):
            if s == len(self.plan) or self.plan[s] != self.plan[start]:
                band = f"L{start}" if s - start == 1 else f"L{start}-{s - 1}"
                parts.append(f"{band}:{label(self.backends[self.plan[start]])}")
                start = s
        return " ".join(parts)

    # -- hot swap ------------------------------------------------------------
    def with_constraints(self, obj) -> "DecodePolicy":
        """A new policy with ``obj`` (matrix or store) in place of the old.

        Only the backends whose kind matches ``obj`` are swapped; every other
        field is kept.  A backend with a compressed slab gets the slab of
        ``obj``: the envelope fixes its shapes and dtype, so a swap inside
        the envelope stays hot.
        """
        stacked = bool(getattr(obj, "is_stacked", False))
        swapped, hit = [], False
        for b in self.backends:
            if isinstance(b, StackedStaticBackend) and stacked:
                field = "store"
            elif (isinstance(b, StaticBackend) and not stacked
                    and isinstance(obj, TransitionMatrix)):
                field = "tm"
            else:
                swapped.append(b)
                continue
            slab = CompressedSlab.build(obj) if b.slab is not None else None
            swapped.append(dataclasses.replace(b, **{field: obj}, slab=slab))
            hit = True
        if not hit:
            raise TypeError(
                f"[{self.describe()}]: no swappable backend accepts "
                f"{type(obj).__name__} (StackedStaticBackend hot-swaps a "
                "ConstraintStore, StaticBackend a TransitionMatrix)")
        return dataclasses.replace(self, backends=tuple(swapped))

    # -- factories ---------------------------------------------------------
    @classmethod
    def static(cls, tm, *, impl: Impl = None, fused: bool = False,
               topk: bool = True, compressed: bool = False) -> "DecodePolicy":
        """STATIC plan: dense bit-packed lookups for levels < ``dense_d``,
        the VNTK (optionally ``fused``) for the deeper levels; ``topk`` runs
        the sparse levels candidate-compressed (DESIGN.md §8);
        ``compressed`` builds the delta-compressed edge slab (DESIGN.md §11)
        and routes every sparse lookup through it, with equal outputs.  A
        stacked store gets :meth:`stacked`."""
        if getattr(tm, "is_stacked", False):
            return cls.stacked(tm, impl=impl, fused=fused, topk=topk,
                               compressed=compressed)
        return cls._plan(StaticBackend, tm, impl, fused, topk, compressed)

    @classmethod
    def stacked(cls, store: ConstraintStore, *, impl: Impl = None,
                fused: bool = False, topk: bool = True,
                compressed: bool = False) -> "DecodePolicy":
        """Multi-tenant STATIC plan over a stacked ConstraintStore."""
        return cls._plan(StackedStaticBackend, store, impl, fused, topk,
                         compressed)

    @classmethod
    def _plan(cls, backend, tables, impl, fused, topk,
              compressed) -> "DecodePolicy":
        L, d = tables.sid_length, min(tables.dense_d, tables.sid_length)
        if d >= L:  # fully dense band: nothing to compress
            return cls(backends=(backend(tables, levels="dense"),),
                       plan=(0,) * L, candidate_topk=topk)
        sparse = backend(tables, slab=(CompressedSlab.build(tables)
                                       if compressed else None),
                         impl=impl, fused=fused, levels="sparse")
        if d == 0:
            return cls(backends=(sparse,), plan=(0,) * L, candidate_topk=topk)
        return cls(backends=(backend(tables, levels="dense"), sparse),
                   plan=tuple(0 if s < d else 1 for s in range(L)),
                   candidate_topk=topk)

    @classmethod
    def cpu_trie(cls, sids=None, vocab_size: Optional[int] = None, *,
                 baseline: Optional[CpuTrieBaseline] = None) -> "DecodePolicy":
        b = baseline or CpuTrieBaseline(sids, vocab_size)
        return cls(backends=(CpuTrieBackend(b),), plan=(0,) * b.sid_length)

    @classmethod
    def ppv(cls, sids=None, vocab_size: Optional[int] = None, *,
            exact: bool = True, top_k: int = 50,
            baseline: Optional[PPVBaseline] = None,
            device=None) -> "DecodePolicy":
        b = (PPVBackend.from_baseline(baseline) if baseline is not None
             else PPVBackend.from_sids(sids, vocab_size, exact=exact,
                                       top_k=top_k, device=device))
        return cls(backends=(b,), plan=(0,) * b.sid_length)

    @classmethod
    def hash_bitmap(cls, sids=None, vocab_size: Optional[int] = None, *,
                    log2_bits: int = 27,
                    baseline: Optional[HashBitmapBaseline] = None,
                    device=None) -> "DecodePolicy":
        b = (HashBitmapBackend.from_baseline(baseline)
             if baseline is not None
             else HashBitmapBackend.from_sids(sids, vocab_size,
                                              log2_bits=log2_bits,
                                              device=device))
        return cls(backends=(b,), plan=(0,) * b.sid_length)

    @classmethod
    def unconstrained(cls) -> "DecodePolicy":
        return cls(backends=(UnconstrainedBackend(),), plan=(0,))

    @classmethod
    def per_level(cls, backends: Sequence, plan: Sequence[int]
                  ) -> "DecodePolicy":
        """Escape hatch: an arbitrary per-level composition."""
        return cls(backends=tuple(backends), plan=tuple(plan))


def as_policy(obj) -> DecodePolicy:
    """A :class:`DecodePolicy` from ``None`` (unconstrained), a
    TransitionMatrix (STATIC), a ConstraintStore (stacked), a §5.2
    baseline, a single backend, or a policy (returned as it is)."""
    if isinstance(obj, DecodePolicy):
        return obj
    if obj is None:
        return DecodePolicy.unconstrained()
    if isinstance(obj, ConstraintStore):
        return DecodePolicy.stacked(obj)
    if isinstance(obj, TransitionMatrix):
        return DecodePolicy.static(obj)
    if isinstance(obj, CpuTrieBaseline):
        return DecodePolicy.cpu_trie(baseline=obj)
    if isinstance(obj, PPVBaseline) and not isinstance(obj, PPVBackend):
        return DecodePolicy.ppv(baseline=obj)
    if isinstance(obj, HashBitmapBaseline) and not isinstance(
            obj, HashBitmapBackend):
        return DecodePolicy.hash_bitmap(baseline=obj)
    if isinstance(obj, BACKENDS):
        return DecodePolicy(backends=(obj,), plan=(0,) * (obj.sid_length or 1))
    raise TypeError(f"cannot build a DecodePolicy from {type(obj).__name__}; "
                    "pass a DecodePolicy, TransitionMatrix, ConstraintStore, "
                    "baseline, backend, or None")
