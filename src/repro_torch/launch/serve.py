"""Batch launcher of the port: STATIC-constrained generative retrieval.

    PYTHONPATH=src python -m repro_torch.launch.serve --config small \\
        --constraints 3000 --batch 2 --beam 4 --requests 2 --device cpu

``--config static_gr`` serves the paper's 3B configuration (SID vocab 2048,
L=8, 256-token histories); ``small`` a 4-layer, 128-wide model over a
256-token SID vocab with L=4 and 16-token histories (the reference
launcher's defaults).  Weights are random, made from ``--seed``.  The run
prints the policy plan, the median batch latency and whether every emitted
beam is a member of the constraint set.  ``--unconstrained`` decodes with no
constraint (the latency lower bound of Table 1): no index is built, and the
share of beams that happen to be in the set is reported, not required.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import static_gr
from repro_torch.configs.base import TransformerConfig
from repro_torch.core import TransitionMatrix
from repro_torch.core.trie import sorted_unique_sids
from repro_torch.core.vntk import NEG_INF
from repro_torch.decoding import DecodePolicy
from repro_torch.models import transformer
from repro_torch.serving.generative_retrieval import GenerativeRetriever

logger = logging.getLogger("repro_torch.launch.serve")


def small_config(vocab: int = 256) -> TransformerConfig:
    """The reduced generative-retrieval transformer (``gr_model_config``)."""
    return TransformerConfig(
        name="gr-small", n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=vocab, head_dim=32, tie_embeddings=True,
        dtype="float32", attn_chunk_q=64, attn_chunk_kv=64)


def is_member(sorted_sids: np.ndarray, sid: np.ndarray) -> bool:
    """Whether ``sid`` is a row of the lexicographically sorted array: one
    binary search per token, narrowing the range of rows sharing the prefix.
    Pass a Fortran-ordered array: ``searchsorted`` copies a strided column."""
    lo, hi = 0, sorted_sids.shape[0]
    for c, t in enumerate(sid):
        col = sorted_sids[lo:hi, c]
        lo, hi = (lo + int(np.searchsorted(col, t, "left")),
                  lo + int(np.searchsorted(col, t, "right")))
        if lo == hi:
            return False
    return True


def compliance(sorted_sids: np.ndarray, beams: np.ndarray,
               scores: np.ndarray) -> tuple[int, int]:
    """(members, live beams): live beams score above ``NEG_INF / 2``."""
    sorted_sids = np.asfortranarray(sorted_sids)
    live = [beams[b, m] for b in range(beams.shape[0])
            for m in range(beams.shape[1]) if scores[b, m] > NEG_INF / 2]
    return sum(is_member(sorted_sids, s) for s in live), len(live)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=["small", "static_gr"], default="small")
    ap.add_argument("--constraints", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--beam", type=int, default=None,
                    help="beam size M (default: 8 small, 70 static_gr)")
    ap.add_argument("--requests", type=int, default=3,
                    help="timed request batches after one warm-up batch")
    ap.add_argument("--unconstrained", action="store_true",
                    help="decode with no constraint (DecodePolicy.unconstrained)")
    ap.add_argument("--fused", action="store_true",
                    help="fold the log-softmax into the VNTK kernel")
    ap.add_argument("--no-topk", action="store_true",
                    help="vocab-aligned constraint step instead of the "
                         "candidate-compressed one (DESIGN.md §8)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch constraint step)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")

    device = resolve_device(args.device)
    if args.config == "static_gr":
        cfg, vocab, L = static_gr.CONFIG, static_gr.SID_VOCAB, static_gr.SID_LENGTH
        hist_len, beam = static_gr.HISTORY_LEN, args.beam or static_gr.BEAM_SIZE
        dense_d = static_gr.DENSE_D
    else:
        cfg, vocab, L, hist_len, beam, dense_d = (small_config(256), 256, 4, 16,
                                                  args.beam or 8, 2)
    rng = np.random.default_rng(args.seed)
    sids = rng.integers(0, vocab, size=(args.constraints, L))
    if args.unconstrained:
        policy = DecodePolicy.unconstrained()
        logger.info("policy %s", policy.describe())
    else:
        t0 = time.time()
        tm = TransitionMatrix.from_sids(sids, vocab, dense_d=dense_d,
                                        device=device)
        policy = DecodePolicy.static(tm, fused=args.fused,
                                     topk=not args.no_topk)
        logger.info("constraint index: %d states (%.2fs build); policy %s",
                    tm.n_states, time.time() - t0, policy.describe())
    params = transformer.init_params(cfg, seed=args.seed, device=device)
    r = GenerativeRetriever(params, cfg, policy, L, vocab, beam_size=beam)
    hist = rng.integers(0, cfg.vocab_size, (args.batch, hist_len))
    lat = []
    for i in range(args.requests + 1):
        t0 = time.perf_counter()
        beams, scores = r.retrieve(hist)  # returns host arrays: synchronized
        if i:
            lat.append(time.perf_counter() - t0)
    members, live = compliance(sorted_unique_sids(sids), beams, scores)
    logger.info("%.1f ms/request-batch of %d (beam %d) on %s; compliance: %s "
                "(%d/%d live beams in the constraint set)",
                float(np.median(lat)) * 1e3, args.batch, beam, device,
                members == live, members, live)
    logger.info("top-1 SIDs: %s", beams[:, 0, :].tolist())
    return 0 if members == live or args.unconstrained else 1


if __name__ == "__main__":
    raise SystemExit(main())
