"""Algorithm 1, Phases 1-2: the constrained decoding step over one matrix or
a stacked store.

Counterpart of ``repro.core.constrained``: thin conveniences over
:class:`~repro_torch.decoding.StaticBackend` and
:class:`~repro_torch.decoding.StackedStaticBackend` for custom decode loops
and per-level timing.  A stacked
:class:`~repro_torch.constraints.ConstraintStore` needs per-row
``constraint_ids`` (same shape as ``nodes``).  ``impl`` is as for the
backends: ``None`` (the kernels on the card, the plain versions on the CPU)
or ``"plain"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.vntk import NEG_INF

__all__ = ["constrain_log_probs", "constrained_decoding_step", "NEG_INF"]


def _backend(tm, impl, fused: bool = False):
    """The StaticBackend or StackedStaticBackend of ``tm`` (imported here:
    ``repro_torch.decoding`` imports the core)."""
    from repro_torch.decoding.backends import (
        StackedStaticBackend,
        StaticBackend,
    )

    if tm.is_stacked:
        return StackedStaticBackend(tm, impl=impl, fused=fused)
    return StaticBackend(tm, impl=impl, fused=fused)


def constrain_log_probs(log_probs, nodes, tm, step: int, impl=None,
                        constraint_ids: Optional[torch.Tensor] = None):
    """Phase 2 of Alg. 1: ``(masked_lp, next_dense)``, both vocab-aligned."""
    if constraint_ids is None and tm.is_stacked:
        raise ValueError("ConstraintStore lookups need per-row constraint_ids")
    return _backend(tm, impl).mask_step(log_probs, nodes, step,
                                        constraint_ids=constraint_ids)


def constrained_decoding_step(logits, nodes, tm, step: int, impl=None,
                              fused: bool = False,
                              constraint_ids: Optional[torch.Tensor] = None):
    """Phases 1-2 of Alg. 1: log-softmax, then the constraint mask.

    With ``tm=None`` the step is unconstrained (the log-softmax alone, the
    latency lower bound of Table 1) and every next state is 1: each token is
    valid and beams stay at the root.  ``fused=True`` folds the log-softmax
    into the sparse levels' kernel.
    """
    if tm is None:
        lp = torch.log_softmax(logits.float(), dim=-1)
        return lp, torch.ones(logits.shape, dtype=torch.int32,
                              device=logits.device)
    if constraint_ids is None and tm.is_stacked:
        raise ValueError("ConstraintStore lookups need per-row constraint_ids")
    backend = _backend(tm, impl, fused=fused)
    if fused:
        return backend.fused_step(logits, nodes, step,
                                  constraint_ids=constraint_ids)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return backend.mask_step(lp, nodes, step, constraint_ids=constraint_ids)
