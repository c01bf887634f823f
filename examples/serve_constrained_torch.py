"""Constrained generative-retrieval serving with batched requests, in the
PyTorch port (``examples/serve_constrained.py`` in torch form).

Builds a small GR model (seeded random weights), a 50k-item restricted
corpus, and serves batched retrieval requests through
``GenerativeRetriever``, then plain token requests through
``ServingEngine``, reporting latency and constraint compliance.

    PYTHONPATH=src python examples/serve_constrained_torch.py  # the card
    PYTHONPATH=src python examples/serve_constrained_torch.py --device cpu

On the card each retrieve runs the candidate-compressed VNTK kernel
(``vntk_topk_warp_kernel``) once per sparse level, 2 launches; the first
retrieve includes building the kernels when they are not built yet.
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import NEG_INF, TransitionMatrix
from repro_torch.decoding import DecodePolicy
from repro_torch.models import transformer
from repro_torch.scenarios import gr_model_config
from repro_torch.serving.engine import RequestQueue, ServingEngine
from repro_torch.serving.generative_retrieval import GenerativeRetriever


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    V, L, M = 256, 4, 8
    cfg = gr_model_config(V)
    params = transformer.init_params(cfg, seed=0, device=dev)

    # Restricted corpus ("in-stock items"): 50k SIDs.
    sids = rng.integers(0, V, size=(50_000, L))
    t0 = time.time()
    tm = TransitionMatrix.from_sids(sids, V, dense_d=2, device=dev)
    print(f"built CSR constraint index for |C|=50k in {time.time()-t0:.2f}s "
          f"({tm.n_states} states)")

    policy = DecodePolicy.static(tm)
    print(f"decode policy: {policy.describe()}")
    retriever = GenerativeRetriever(params, cfg, policy, sid_length=L,
                                    sid_vocab=V, beam_size=M)
    B = 4
    hist = rng.integers(0, V, size=(B, 16)).astype(np.int32)
    t0 = time.time()
    beams, scores = retriever.retrieve(hist)  # includes the kernel build
    print(f"first batch (compile) {time.time()-t0:.2f}s")
    t0 = time.time()
    n = 5
    for _ in range(n):
        beams, scores = retriever.retrieve(hist)
    dt = (time.time() - t0) / n
    valid = {tuple(r) for r in sids}
    ok = all(
        tuple(beams[b, m]) in valid
        for b in range(B) for m in range(M)
        if scores[b, m] > NEG_INF / 2
    )
    print(f"batched retrieval: {dt*1e3:.1f} ms/batch of {B} "
          f"({M} beams x {L} SID levels); 100% compliance: {ok}")

    # plain token serving through the batch engine
    eng = ServingEngine(params, cfg, batch_size=4, max_len=64)
    q = RequestQueue()
    for _ in range(8):
        q.submit(rng.integers(0, V, size=(12,)), n_tokens=6)
    t0 = time.time()
    results = eng.serve(q)
    lengths = sorted(len(v) for v in results.values())
    print(f"continuous batching drained 8 requests in {time.time()-t0:.2f}s; "
          f"lengths: {lengths}")
    return dict(n_states=tm.n_states, compliance=ok, retrieve_ms=dt * 1e3,
                lengths=lengths, searches=1 + n, plan=policy.plan_info(M))


if __name__ == "__main__":
    main()
