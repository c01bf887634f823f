"""The comparison that decides whether a served retrieval run is correct.

Three numbers, each against a limit the configuration states:

* ``bad_beams`` (limit 0, exact), over every request answered in the window:
  beams whose score is not finite, live beams whose SID is not in the
  request's set, SIDs returned twice for one request, scores out of
  descending order, and dead beams where the set has at least ``M``
  distinct first tokens (then beam search keeps ``M`` live beams).
* ``score_gap`` (nats), over a seeded sample of requests: the widest
  distance between a served beam's score and the reference's score of the
  same SID after the same history (the prefill's and every decode step's
  log-probabilities, summed).
* ``misselected`` (limit 0, exact), over the same sample: the last step
  keeps the ``M`` best children of the beams before it, which are the served
  SIDs' prefixes; every child the set allows them is scored by the
  reference, and each child not served that lies more than a tolerance
  above the worst one served is counted.  The tolerance is three times the
  request's own widest score gap: where the program's scores lie within
  that gap of the reference's, its selection can swap only children closer
  than twice it.  A last level that drops allowed tokens, or a selection
  that keeps worse children, shows here.

A beam is live when its score is above ``DEAD`` (the program marks beams it
could not fill with a score near -1e10).
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.decoder import Decoder, no_tf32
from gpubench.reference.search import beam_scores, search

__all__ = ["bad_beams", "sample_gaps", "control_outputs", "DEAD"]

DEAD = -1.0e9


def _bad_in_request(catalog, cid, sids: np.ndarray, scores: np.ndarray,
                    beams: int) -> int:
    finite = np.isfinite(scores)
    live = finite & (scores > DEAD)
    bad = int((~finite).sum())
    if live.any():
        s = sids[live]
        bad += int((~catalog.contains(cid, s)).sum())
        bad += s.shape[0] - np.unique(s, axis=0).shape[0]
    f = scores[finite]
    bad += int((f[1:] > f[:-1]).sum())
    if catalog.first_tokens(cid) >= beams:
        bad += int((finite & ~live).sum())
    return bad


def bad_beams(catalog, served: list, beams: int) -> int:
    """Faults of the checks that need no model, over every served request
    (``served``: dicts with ``cid``, ``sids`` (M, L), ``scores`` (M,))."""
    return sum(_bad_in_request(catalog, r["cid"], np.asarray(r["sids"]),
                               np.asarray(r["scores"], np.float64), beams)
               for r in served)


def _misselected(sidset, sids: np.ndarray, ref: np.ndarray,
                 last_lp: np.ndarray, tolerance: float) -> int:
    """Children of the served prefixes, not served, whose reference score
    lies more than ``tolerance`` above the worst served SID's."""
    served = {tuple(s) for s in sids.tolist()}
    floor = float(ref.min()) + tolerance
    count, seen = 0, set()
    for r in range(sids.shape[0]):
        parent = tuple(sids[r, :-1].tolist())
        if parent in seen:
            continue
        seen.add(parent)
        lo, hi = sidset.prefix_range(parent)
        toks = np.unique(sidset.cols[-1][lo:hi]).astype(np.int64)
        out = [t for t in toks.tolist() if parent + (t,) not in served]
        if out:
            base = ref[r] - last_lp[r, sids[r, -1]]  # the parent's score
            count += int((base + last_lp[r, out] > floor).sum())
    return count


def sample_gaps(dec: Decoder, catalog, served: list, vocab: int) -> dict:
    """``score_gap`` and ``misselected`` over the requests ``served`` (each
    with ``history`` (S,) too), one request at a time."""
    score_gap, misselected = 0.0, 0
    with torch.inference_mode(), no_tf32():
        for r in served:
            hist = dec.history(torch.as_tensor(np.asarray(r["history"]),
                                               dtype=torch.int64,
                                               device=dec.device))
            scores = np.asarray(r["scores"], np.float64)
            live = np.isfinite(scores) & (scores > DEAD)
            sids = np.asarray(r["sids"], np.int64)[live]
            if sids.shape[0] == 0:
                continue
            ref, last_lp = beam_scores(dec, hist, sids, vocab)
            gap = float(np.abs(scores[live] - ref).max())
            score_gap = max(score_gap, gap)
            misselected += _misselected(catalog.set(r["cid"]), sids, ref,
                                        last_lp, 3.0 * gap)
            del hist
    return {"score_gap": score_gap, "misselected": misselected}


def control_outputs(dec: Decoder, catalog, requests: list, beams: int,
                    length: int, vocab: int) -> list:
    """What ``dec`` (the control) serves in the program's place: its own
    search over each request's set, with its own scores."""
    out = []
    with torch.inference_mode(), no_tf32():
        for r in requests:
            hist = dec.history(torch.as_tensor(np.asarray(r["history"]),
                                               dtype=torch.int64,
                                               device=dec.device))
            sids, scores = search(dec, hist, catalog.set(r["cid"]), beams,
                                  length, vocab)
            out.append(dict(r, sids=sids, scores=scores))
    return out
