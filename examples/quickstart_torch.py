"""Quickstart: build a STATIC constraint index and run constrained decoding
with the PyTorch port (``examples/quickstart.py`` in torch form).

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On the card, levels 2-3 of the search run the candidate-compressed VNTK
kernel (``vntk_topk_warp_kernel``, one launch a level); levels 0-1 are the
dense bit-packed lookups, which launch no kernel.  ``--impl plain`` runs
the kernel's plain PyTorch version instead.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (
    NEG_INF, TransitionMatrix, beam_search, constrained_decoding_step,
)
from repro_torch.decoding import DecodePolicy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--impl", choices=["cuda", "plain"], default="cuda",
                    help="the sparse levels' constraint step: the CUDA "
                         "kernel or its plain PyTorch version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    impl = "plain" if args.impl == "plain" else None
    rng = np.random.default_rng(0)
    vocab, length = 64, 4

    # 1. The restricted vocabulary C: 200 Semantic IDs (e.g. "fresh items").
    sids = rng.integers(0, vocab, size=(200, length))
    print(f"|C| = {len(np.unique(sids, axis=0))} SIDs, |V| = {vocab}, "
          f"L = {length}")

    # 2. Offline: flatten the prefix tree into the CSR transition matrix.
    tm = TransitionMatrix.from_sids(sids, vocab, dense_d=2, device=dev)
    print(f"trie: {tm.n_states} states, {tm.n_edges} edges, "
          f"per-level max branch factors B = {tm.level_bmax}")

    # 3. One constrained decoding step (Algorithm 1): mask model logits.
    logits = torch.as_tensor(
        rng.normal(size=(2, 3, vocab)).astype(np.float32), device=dev)
    nodes = torch.ones((2, 3), dtype=torch.int32, device=dev)  # at the root
    masked, _ = constrained_decoding_step(logits, nodes, tm, step=0,
                                          impl=impl)
    n_valid = int((masked[0, 0] > NEG_INF / 2).sum())
    print(f"step 0: {n_valid} valid first tokens out of {vocab}")

    # 4. Full constrained beam search under a DecodePolicy: dense bit-packed
    # lookups for the first dense_d levels, the VNTK for the rest.
    policy = DecodePolicy.static(tm, impl=impl)
    print(f"decode policy: {policy.describe()}")
    table = torch.as_tensor(
        rng.normal(size=(length, vocab)).astype(np.float32), device=dev)

    def logits_fn(carry, last, step):
        B, M = last.shape
        return table[step].expand(B, M, vocab), carry

    B, M = 2, 8
    state, _ = beam_search(logits_fn, None, batch_size=B, beam_size=M,
                           length=length, policy=policy)
    valid = {tuple(r) for r in sids}
    beams = state.tokens.cpu().numpy()
    scores = state.scores.cpu().numpy()
    ok = all(
        tuple(beams[b, m]) in valid
        for b in range(B) for m in range(M)
        if scores[b, m] > NEG_INF / 2
    )
    print(f"top beam: {beams[0, 0].tolist()}  score {float(scores[0, 0]):.3f}")
    print(f"100% compliance with C: {ok}")
    return dict(n_states=tm.n_states, n_edges=tm.n_edges,
                level_bmax=tm.level_bmax, n_valid=n_valid,
                top_beam=beams[0, 0].tolist(), top_score=float(scores[0, 0]),
                compliance=ok, beams=beams, scores=scores, searches=1,
                plan=policy.plan_info(M))


if __name__ == "__main__":
    main()
