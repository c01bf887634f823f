"""Batched constrained beam search over Semantic IDs (paper §3.2 + Alg. 1).

Counterpart of ``repro.core.beam_search``: per batch element the ``M`` best
prefixes, their cumulative log-probs and per-beam constraint states (trie
nodes for STATIC, the emitted tokens for the §5.2 baselines), advanced by a
:class:`~repro_torch.decoding.DecodePolicy`.  The decoder is
``logits_fn(carry, last_tokens, step) -> (logits, carry)``.

Top-M selection keeps ``jax.lax.top_k``'s order: ties go to the lower flat
index.  ``torch.topk`` promises no tie order, so selection is a stable
descending sort (:func:`top_m`).

Each level's parts are spans of a profiler trace (``decode_step``,
``constraint_step``, ``beam_select``, ``cache_reorder``, each with its
``level``; :data:`repro_torch.observability.SPANS`), no-ops when no
profiler records.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.vntk import NEG_INF, top_m
from repro_torch.observability.profiling import annotate

__all__ = ["BeamState", "beam_search", "recall_at_k", "top_m"]

LogitsFn = Callable  # (carry, last_tokens (B, M) int32, step) -> (logits, carry)
CarryGatherFn = Callable  # (carry, beam_idx (B, M) int64) -> carry


@dataclasses.dataclass
class BeamState:
    tokens: torch.Tensor  # (B, M, L) int32 decoded prefixes
    scores: torch.Tensor  # (B, M) float32 cumulative log-probs
    nodes: torch.Tensor  # (B, M) int32 per-beam trie states (ROOT init)


def _init_state(batch: int, beams: int, length: int, device) -> BeamState:
    scores = torch.full((batch, beams), NEG_INF, dtype=torch.float32,
                        device=device)
    scores[:, 0] = 0.0
    return BeamState(
        tokens=torch.zeros((batch, beams, length), dtype=torch.int32,
                           device=device),
        scores=scores,
        nodes=torch.ones((batch, beams), dtype=torch.int32, device=device),
    )


def beam_search(
    logits_fn: LogitsFn,
    carry,
    batch_size: int,
    beam_size: int,
    length: int,
    policy,
    carry_gather_fn: Optional[CarryGatherFn] = None,
    first_logits: Optional[torch.Tensor] = None,
    constraint_ids=None,
    return_trace: bool = False,
    device=None,
):
    """Run ``length`` constrained decode steps; beams come out score-sorted.

    ``first_logits`` (B, V) stands in for step 0 (the prefill's last
    position).  The state lives on ``first_logits``' device when it is
    given, else on the device of the tables the policy holds, else on
    ``device``; a policy without tables (the host trie, the unconstrained
    step) and no ``first_logits`` needs ``device``.
    ``carry_gather_fn`` reorders the carry after every step that another
    step follows; after the last step no logits are read, so the returned
    carry is not reordered for it.

    ``constraint_ids`` (B,) selects, per batch row, which member of a stacked
    :class:`~repro_torch.constraints.ConstraintStore` masks that row: every
    beam of a row shares its request's set, so the ids broadcast over the
    beam axis once and beam reordering never moves them (DESIGN.md §4).

    Returns ``(state, carry)``, or ``(state, carry, trace)`` with
    ``return_trace`` — ``trace`` is a :class:`BeamState` whose fields carry a
    leading step axis (the post-advance beams at every level).
    """
    from repro_torch.decoding.policy import as_policy  # lazy: import cycle

    policy = as_policy(policy)
    if policy.requires_constraint_ids and constraint_ids is None:
        raise ValueError("ConstraintStore lookups need per-row constraint_ids")
    if constraint_ids is not None and not policy.requires_constraint_ids:
        raise ValueError(
            "constraint_ids requires a stacked ConstraintStore policy")
    B, M = batch_size, beam_size
    if first_logits is not None:
        device = first_logits.device
    elif policy.device is not None:
        device = policy.device
    elif device is None:
        raise ValueError(
            f"[{policy.describe()}] holds no device tables: pass "
            "first_logits or device=")
    state = _init_state(B, M, length, device)
    cids_bm = (None if constraint_ids is None else torch.as_tensor(
        constraint_ids, dtype=torch.int32, device=device)[:, None].expand(B, M))
    batch_ix = torch.arange(B, device=device)[:, None]
    trace = []
    for step in range(length):
        if step == 0 and first_logits is not None:
            logits = first_logits[:, None, :].expand(
                B, M, first_logits.shape[-1])
        else:
            with annotate("decode_step", level=step):
                last = (state.tokens[:, :, step - 1] if step > 0 else
                        torch.zeros((B, M), dtype=torch.int32,
                                    device=device))
                logits, carry = logits_fn(carry, last, step)  # (B, M, V)
        V = logits.shape[-1]
        topk = policy.supports_topk_at(step)
        with annotate("constraint_step", level=step):
            if topk:
                # candidate-compressed advance (DESIGN.md §8): the lists
                # carry the dense rows' top-C in flat-index tie order,
                # C >= min(M, V)
                C = policy.candidate_width(M, step)
                lp, c_tok, c_next = policy.step_topk(
                    logits, state.nodes, step, C, constraint_ids=cids_bm)
            else:
                lp, next_dense = policy.step(
                    logits, state.nodes, step, constraint_ids=cids_bm,
                    prefix_tokens=(state.tokens if policy.needs_prefix
                                   else None))
        with annotate("beam_select", level=step):
            W = lp.shape[-1]  # C candidates a beam, or the V dense tokens
            total = state.scores[:, :, None] + lp  # (B, M, W)
            top_scores, top_idx = top_m(total.reshape(B, M * W), M)
            beam_idx = top_idx // W
            if topk:
                token = c_tok.reshape(B, M * W).gather(1, top_idx)
                new_nodes = c_next.reshape(B, M * W).gather(1, top_idx)
            else:
                token = (top_idx % V).to(torch.int32)
                new_nodes = next_dense[batch_ix, beam_idx, token.long()]
            new_tokens = state.tokens[batch_ix, beam_idx]  # (B, M, L)
            new_tokens[:, :, step] = token
            state = BeamState(tokens=new_tokens, scores=top_scores,
                              nodes=new_nodes.to(torch.int32))
        if return_trace:
            trace.append(state)
        if carry_gather_fn is not None and step < length - 1:
            with annotate("cache_reorder", level=step):
                carry = carry_gather_fn(carry, beam_idx)
    if return_trace:
        stacked = BeamState(*(torch.stack([getattr(s, f.name) for s in trace])
                              for f in dataclasses.fields(BeamState)))
        return state, carry, stacked
    return state, carry


def recall_at_k(beams: torch.Tensor, targets: torch.Tensor, k: int):
    """Fraction of batch rows whose target appears in the top-k beams."""
    hit = torch.all(beams[:, :k, :] == targets[:, None, :], dim=-1)
    return hit.any(dim=-1).float().mean()
