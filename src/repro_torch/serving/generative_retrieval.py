"""STATIC-constrained generative-retrieval server (the paper's use case).

Counterpart of ``repro.serving.generative_retrieval``:
``GenerativeRetriever.retrieve`` prefills the model once per request, tiles
the request's KV cache across the ``M`` beams, then runs the constrained
beam search of Algorithm 1 over SID tokens.  The prefill's last-position
logits stand in for step 0, so a retrieve runs ``L - 1`` decode steps and
``L - 1`` beam reorders of the cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.beam_search import beam_search
from repro_torch.decoding import as_policy
from repro_torch.models import transformer

__all__ = ["GenerativeRetriever"]


class GenerativeRetriever:
    """Serves on the device of ``params`` (and of the policy's matrix)."""

    def __init__(self, params, cfg: TransformerConfig, policy,
                 sid_length: int, sid_vocab: int, beam_size: int = 20):
        self.params = params
        self.cfg = cfg
        self.policy = as_policy(policy)
        self.L = sid_length
        self.V = sid_vocab
        self.M = beam_size
        self.device = params["emb"].device
        if self.policy.constraints.device != self.device:
            raise ValueError(
                f"constraints on {self.policy.constraints.device}, model on "
                f"{self.device}")

    def retrieve(self, history: np.ndarray):
        """history (B, S) int -> (sids (B, M, L) int32, scores (B, M) f32)."""
        with torch.inference_mode():
            hist = torch.as_tensor(np.asarray(history, np.int64),
                                   device=self.device)
            tokens, scores = self._retrieve(hist)
            return tokens.cpu().numpy(), scores.cpu().numpy()

    def _retrieve(self, history: torch.Tensor):
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
        )
        return state.tokens, state.scores
