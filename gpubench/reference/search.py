"""Constrained beam search and beam scoring on the plain decoder.

The search is the paper's Algorithm 1 read plainly: a beam's score is the sum
of its tokens' log-probabilities (log-softmax of the logits over the first
``vocab`` ids, the SID vocabulary); step 0 scores the history's last
position, and each later step extends every beam by each token its prefix
allows in the set and keeps the ``M`` best (beam, token) pairs.  A prefix's
allowed tokens come from the set's sorted rows (:class:`~.sets.SidSet`).
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.decoder import Decoder, History

__all__ = ["search", "beam_scores"]


def _log_probs(logits: torch.Tensor, vocab: int) -> np.ndarray:
    return torch.log_softmax(logits[..., :vocab].to(torch.float32),
                             dim=-1).cpu().numpy()


def search(dec: Decoder, hist: History, sidset, beams: int, length: int,
           vocab: int):
    """The ``beams`` best SIDs of ``sidset`` after ``hist``:
    (tokens (k, length) int64, scores (k,) float64), best first; ``k`` is
    less than ``beams`` only where the set has fewer prefixes."""
    lp0 = _log_probs(hist.last_logits, vocab)
    tok, lo, hi = sidset.children(0, len(sidset), 0)
    order = np.argsort(-lp0[tok], kind="stable")[:beams]
    prefix = tok[order][:, None]
    scores = lp0[tok[order]].astype(np.float64)
    lo, hi = lo[order], hi[order]
    dev = hist.last_logits.device
    for t in range(1, length):
        lp = _log_probs(dec.suffix_logits(
            hist, torch.as_tensor(prefix, device=dev), last_only=True), vocab)
        cand_beam, cand_tok, cand_lo, cand_hi, cand_score = [], [], [], [], []
        for r in range(prefix.shape[0]):
            ct, cl, ch = sidset.children(lo[r], hi[r], t)
            cand_beam.append(np.full(ct.shape[0], r))
            cand_tok.append(ct)
            cand_lo.append(cl)
            cand_hi.append(ch)
            cand_score.append(scores[r] + lp[r, ct])
        cand_score = np.concatenate(cand_score)
        keep = np.argsort(-cand_score, kind="stable")[:beams]
        parent = np.concatenate(cand_beam)[keep]
        prefix = np.concatenate([prefix[parent],
                                 np.concatenate(cand_tok)[keep][:, None]], 1)
        scores = cand_score[keep]
        lo, hi = np.concatenate(cand_lo)[keep], np.concatenate(cand_hi)[keep]
    return prefix, scores


def beam_scores(dec: Decoder, hist: History, sids: np.ndarray,
                vocab: int) -> tuple:
    """Each SID's (R, L) score after ``hist`` (the sum of its tokens'
    log-probabilities, (R,) float64) and the log-probabilities (R, vocab)
    at its last position, where its last token was chosen."""
    lp0 = _log_probs(hist.last_logits, vocab)
    total = lp0[sids[:, 0]].astype(np.float64)
    if sids.shape[1] == 1:
        return total, np.broadcast_to(lp0, (sids.shape[0], vocab))
    dev = hist.last_logits.device
    lp = _log_probs(dec.suffix_logits(
        hist, torch.as_tensor(sids[:, :-1], device=dev)), vocab)
    total += np.take_along_axis(lp, sids[:, 1:, None], 2)[..., 0].sum(1)
    return total, lp[:, -1]
