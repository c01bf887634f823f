"""STATIC-constrained generative-retrieval server (the paper's use case).

Counterpart of ``repro.serving.generative_retrieval``:
``GenerativeRetriever.retrieve`` prefills the model once per request, tiles
the request's KV cache across the ``M`` beams, then runs the constrained
beam search of Algorithm 1 over SID tokens.  The prefill's last-position
logits stand in for step 0, so a retrieve runs ``L - 1`` decode steps and
``L - 1`` beam reorders of the cache.

The policy may be any of the paper's §5.2 baselines (CPU trie, DISC-PPV,
hash bitmap) or ``None`` (unconstrained): they serve through the same path.

Multi-tenant mode (DESIGN.md §4): with a stacked policy
(``DecodePolicy.stacked(store)``, or just the ConstraintStore) ``retrieve``
takes a per-request ``constraint_ids`` vector and decodes each batch row
under its own constraint set.  ``set_constraints`` installs a refreshed
matrix or store.  A swap is *hot* when it changes no tensor shape, dtype or
static field of the policy (``n_states``, ``n_edges``, ``level_bmax``,
``num_sets``, ...): then nothing keyed on those shapes (a captured CUDA
graph, say) needs rebuilding.  That is the port's form of the reference's
zero-recompile promise.  ``retrieve`` counts each key it has not run under
before, ``(_signature(policy), history shape, whether constraint ids are
given)``, as one specialization
(:func:`repro_torch.observability.compile_events`): the first batch counts
1, a hot swap 0, a cold swap 1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.beam_search import beam_search
from repro_torch.decoding import as_policy
from repro_torch.models import transformer
from repro_torch.observability.timing import record_specialization

__all__ = ["GenerativeRetriever"]


class GenerativeRetriever:
    """Serves on the device of ``params``, where the tables of the policy
    must lie too.  ``policy=None`` decodes unconstrained; a §5.2 baseline
    serves through the same path as STATIC."""

    def __init__(self, params, cfg: TransformerConfig, policy=None,
                 sid_length: Optional[int] = None,
                 sid_vocab: Optional[int] = None, beam_size: int = 20):
        if sid_length is None or sid_vocab is None:
            raise TypeError("sid_length and sid_vocab are required")
        self.params = params
        self.cfg = cfg
        self.policy = as_policy(policy)
        self.L = sid_length
        self.V = sid_vocab
        self.M = beam_size
        self.device = params["emb"].device
        self._specializations = set()  # keys retrieve has run under
        for b in self.policy.backends:
            if b.device is not None and b.device != self.device:
                raise ValueError(f"{type(b).__name__} tables on {b.device}, "
                                 f"model on {self.device}")

    # -- constraint plumbing -----------------------------------------------
    @property
    def num_sets(self) -> Optional[int]:
        """Stacked-store member count, or None when single-tenant."""
        return self.policy.num_sets

    @property
    def constraints(self):
        """The TransitionMatrix or ConstraintStore served, or ``None`` under
        a baseline or unconstrained policy (read-only; install a refreshed
        one with :meth:`set_constraints`)."""
        return self.policy.constraints

    def set_constraints(self, obj) -> bool:
        """Install a refreshed matrix or store; returns True iff the swap was
        cold (some tensor shape, dtype or static field of the policy
        changed)."""
        before = _signature(self.policy)
        self.policy = self.policy.with_constraints(obj)
        return _signature(self.policy) != before

    # -- serving -------------------------------------------------------------
    def retrieve(self, history: np.ndarray,
                 constraint_ids: Optional[np.ndarray] = None):
        """history (B, S) int -> (sids (B, M, L) int32, scores (B, M) f32).

        ``constraint_ids`` (B,) selects each request's set from the stacked
        store of ``self.policy``; an id outside ``[0, num_sets)`` raises
        (the kernels would clamp it, serving the wrong constraint).
        """
        cids = None
        if constraint_ids is not None:
            cids = np.asarray(constraint_ids, np.int32)
            num_sets = self.num_sets
            if num_sets is not None and (cids.min() < 0
                                         or cids.max() >= num_sets):
                raise ValueError(
                    f"constraint_ids must be in [0, {num_sets}), got "
                    f"range [{cids.min()}, {cids.max()}]")
        key = (_signature(self.policy), np.shape(history), cids is not None)
        if key not in self._specializations:
            self._specializations.add(key)
            record_specialization()
        with torch.inference_mode():
            hist = torch.as_tensor(np.asarray(history, np.int64),
                                   device=self.device)
            if cids is not None:
                cids = torch.as_tensor(cids, device=self.device)
            tokens, scores = self._retrieve(hist, cids)
            return tokens.cpu().numpy(), scores.cpu().numpy()

    def _retrieve(self, history: torch.Tensor, constraint_ids=None):
        B, S = history.shape
        M, V = self.M, self.V
        pre_logits, cache = transformer.prefill(
            self.params, history, self.cfg, max_len=S + self.L + 1)
        # tile the request cache across beams: (L, B, ...) -> (L, B*M, ...)
        cache = dataclasses.replace(
            cache, k=cache.k.repeat_interleave(M, dim=1),
            v=cache.v.repeat_interleave(M, dim=1))

        def logits_fn(c, last_tokens, step):
            logits, c = transformer.decode_step(
                self.params, c, last_tokens.reshape(B * M, 1), self.cfg)
            return logits[:, 0, :V].reshape(B, M, V), c

        def gather_cache(c, beam_idx):
            flat = (torch.arange(B, device=beam_idx.device)[:, None] * M
                    + beam_idx).reshape(-1)
            return dataclasses.replace(c, k=c.k.index_select(1, flat),
                                       v=c.v.index_select(1, flat))

        state, _ = beam_search(
            logits_fn, cache, B, M, self.L, self.policy,
            carry_gather_fn=gather_cache,
            first_logits=pre_logits[:, 0, :V],
            constraint_ids=constraint_ids,
        )
        return state.tokens, state.scores


def _signature(policy) -> tuple:
    """Every static field and tensor shape/dtype/device of a policy: what a
    hot swap leaves unchanged."""
    def fields(obj):
        out = [type(obj).__name__]
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                out.append((f.name, tuple(v.shape), v.dtype, v.device))
            elif dataclasses.is_dataclass(v):
                out.append((f.name, fields(v)))
            elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
                out.append((f.name, tuple(fields(x) for x in v)))
            else:
                out.append((f.name, v))
        return tuple(out)

    return fields(policy)
