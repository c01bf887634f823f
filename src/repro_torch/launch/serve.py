"""Launcher of the port: STATIC-constrained generative retrieval.

    PYTHONPATH=src python -m repro_torch.launch.serve --config small \\
        --constraints 3000 --batch 2 --beam 4 --requests 2 --device cpu

``--config static_gr`` serves the paper's 3B configuration (SID vocab 2048,
L=8, 256-token histories); ``small`` a 4-layer, 128-wide model over a
``--vocab``-token SID vocab (256) with L = ``--sid-length`` (4) and
16-token histories (the reference launcher's defaults).  Weights are
random, made from ``--seed``.  The reference's options are all here, with
its defaults (``--batch`` 4, ``--requests`` 5, ``--log-level``); ``--impl``
takes the port's values: ``cuda`` (default: the CUDA kernels on the card,
their plain versions on CPU tensors) or ``plain`` (the plain PyTorch
constraint step, on the card too).

``--engine`` picks how requests are served:

* ``batch`` (default): ``GenerativeRetriever.retrieve`` over fixed batches
  of ``--batch`` requests, timed by ``StepTimer`` (one warm-up and
  ``--requests`` synchronized trials); the run prints the policy plan, the
  median and p99 batch latency, the dispatch median and the steady
  specializations.
* ``continuous``: ``ContinuousServingEngine`` (DESIGN.md §10) over a
  ``RequestQueue`` of ``--requests * --batch`` requests drawn from a pool
  of a third as many prompts (so repeats share their prefill), with
  ``--batch`` slots and ``--batch // 2`` fresh prefills per step.  Its
  level-free mask needs the all-sparse index, so the index is built at
  ``dense_d=0``.  The run prints the request latencies, slot reuse and
  both share-hit counts.
* ``spmd`` (or ``--spmd``): ``SpmdRetriever`` over a ``(data, model)``
  process mesh (DESIGN.md §6), timed like ``batch``.  Under ``torchrun``
  (``torchrun --nproc-per-node N -m repro_torch.launch.serve --engine
  spmd``) every rank joins that world, one card each; otherwise the run is
  a world of one.  ``--spmd-rows replicated`` (default) replicates the trie
  and splits the batch over every rank; ``--spmd-rows model`` puts two
  ranks on the ``model`` axis, each holding half the CSR edge slab, and
  serves the plain-torch row-sharded step (``impl="plain"``).

Every engine checks that every emitted beam is a member of the
constraint set, and exits 1 if one is not.  ``--unconstrained`` (batch
only) decodes with no constraint (the latency lower bound of Table 1): no
index is built, and the share of beams in the set is reported, not
required.  ``--fault-schedule`` arms the deterministic fault injector
(DESIGN.md §13; inline JSON or a file); a request the faults shed is
reported, not checked.  ``--metrics-json`` appends a snapshot of the run's
``MetricsRegistry`` to a JSON-lines file at the end.  ``--metrics-port-file``
and ``--health-port-file`` serve the registry at ``/metrics`` (and
``/healthz``, ``/readyz``, ``/livez`` from a ``HealthMonitor`` over the
serving circuit breaker) on an ephemeral localhost port for the run, and
write the bound port to the file.
"""
from __future__ import annotations

import argparse
import logging
import time
from contextlib import nullcontext

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import static_gr
from repro_torch.configs.base import TransformerConfig
from repro_torch.core import TransitionMatrix
from repro_torch.core.trie import sorted_unique_sids
from repro_torch.core.vntk import NEG_INF
from repro_torch.decoding import DecodePolicy
from repro_torch.launch.mesh import make_debug_mesh, world
from repro_torch.models import transformer
from repro_torch.observability import MetricsRegistry, StepTimer, start_http_server
from repro_torch.reliability import (
    CircuitBreaker,
    FaultInjector,
    HealthMonitor,
    active_injector,
)
from repro_torch.serving import RequestQueue
from repro_torch.serving.continuous import ContinuousServingEngine
from repro_torch.serving.generative_retrieval import GenerativeRetriever
from repro_torch.serving.spmd_engine import SpmdRetriever

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
    ap.add_argument("--vocab", type=int, default=256,
                    help="SID vocab of --config small (static_gr: 2048)")
    ap.add_argument("--sid-length", type=int, default=4,
                    help="SID length L of --config small (static_gr: 8)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--beam", type=int, default=None,
                    help="beam size M (default: 8 small, 70 static_gr)")
    ap.add_argument("--requests", type=int, default=5,
                    help="timed request batches after one warm-up batch")
    ap.add_argument("--unconstrained", action="store_true",
                    help="decode with no constraint (DecodePolicy.unconstrained)")
    ap.add_argument("--impl", choices=["cuda", "plain"], default="cuda",
                    help="constraint step on the sparse levels: the CUDA "
                         "kernels (their plain versions on CPU tensors) or "
                         "the plain PyTorch step")
    ap.add_argument("--fused", action="store_true",
                    help="fold the log-softmax into the VNTK kernel")
    ap.add_argument("--no-topk", action="store_true",
                    help="vocab-aligned constraint step instead of the "
                         "candidate-compressed one (DESIGN.md §8)")
    ap.add_argument("--engine", choices=["batch", "continuous", "spmd"],
                    default="batch",
                    help="batch: retrieve over fixed batches; continuous: "
                         "the step-boundary ContinuousServingEngine over a "
                         "request queue (builds the index at dense_d=0); "
                         "spmd: SpmdRetriever over a process mesh")
    ap.add_argument("--spmd", action="store_true",
                    help="alias for --engine spmd: serve over a (data, "
                         "model) mesh of every rank of the torchrun world, "
                         "or a world of one")
    ap.add_argument("--spmd-rows", choices=["replicated", "model"],
                    default="replicated",
                    help="CSR placement under --engine spmd: replicate the "
                         "trie (paper §A.3) or row-shard its edges over a "
                         "2-way model axis with a one-hop all-reduce "
                         "(DESIGN.md §6; the plain-torch step)")
    ap.add_argument("--metrics-json", metavar="PATH", default=None,
                    help="append a JSON-lines MetricsRegistry snapshot to "
                         "PATH on exit (DESIGN.md §9)")
    ap.add_argument("--metrics-port-file", metavar="PATH", default=None,
                    help="serve Prometheus text at /metrics on an ephemeral "
                         "localhost port and write the bound port to PATH")
    ap.add_argument("--health-port-file", metavar="PATH", default=None,
                    help="serve /healthz, /readyz and /livez (plus /metrics) "
                         "on an ephemeral localhost port and write the bound "
                         "port to PATH; readiness reflects the serving "
                         "circuit breaker")
    ap.add_argument("--fault-schedule", metavar="JSON", default=None,
                    help="arm the deterministic fault injector (DESIGN.md "
                         "§13): inline JSON or a path to a JSON file of the "
                         "form {\"seed\": 0, \"faults\": [{\"point\": ..., "
                         "\"mode\": ...}, ...]}")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch constraint step)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-level", default="INFO",
                    choices=["DEBUG", "INFO", "WARNING", "ERROR"],
                    help="stdlib logging level for the repro_torch.* loggers")
    args = ap.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level),
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    if args.config == "static_gr" and (args.vocab, args.sid_length) not in (
            (256, 4), (static_gr.SID_VOCAB, static_gr.SID_LENGTH)):
        ap.error(f"--config static_gr serves SID vocab {static_gr.SID_VOCAB} "
                 f"and length {static_gr.SID_LENGTH}; --vocab and "
                 "--sid-length set --config small")

    device = resolve_device(args.device)
    if args.spmd:
        args.engine = "spmd"
    if args.engine == "continuous" and args.unconstrained:
        ap.error("--unconstrained serves the batch engine only (the "
                 "continuous engine masks level-free over an index)")
    injector = None
    if args.fault_schedule:
        injector = FaultInjector.from_json(args.fault_schedule)
        logger.info("fault injection armed (seed=%d)", injector.seed)
    metrics = MetricsRegistry()
    breaker = CircuitBreaker(name="serve", metrics=metrics)
    server = None
    if args.metrics_port_file or args.health_port_file:
        health = (HealthMonitor(breaker=breaker, metrics=metrics)
                  if args.health_port_file else None)
        server, port = start_http_server(metrics, port=0, health=health)
        for path in (args.metrics_port_file, args.health_port_file):
            if path:
                with open(path, "w") as f:
                    f.write(str(port))
        logger.info("metrics: http://127.0.0.1:%d/metrics", port)
        if health is not None:
            logger.info("health:  http://127.0.0.1:%d/healthz", port)
    try:
        # the injector is uninstalled on the way out; spmd joins torchrun's
        # world, or makes a world of one and destroys it after
        spmd = world(device) if args.engine == "spmd" else nullcontext()
        with active_injector(injector), spmd:
            return serve(args, device, injector, metrics, breaker)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()


def serve(args, device, injector, metrics, breaker) -> int:
    """Build the index and the model, serve, check compliance; the exit
    code."""
    continuous = args.engine == "continuous"
    if args.config == "static_gr":
        cfg, vocab, L = static_gr.CONFIG, static_gr.SID_VOCAB, static_gr.SID_LENGTH
        hist_len, beam = static_gr.HISTORY_LEN, args.beam or static_gr.BEAM_SIZE
        dense_d = static_gr.DENSE_D
    else:
        vocab, L = args.vocab, args.sid_length
        cfg, hist_len, dense_d = small_config(vocab), 16, 2
        beam = args.beam or 8
    if continuous:  # level-free masking needs node ids unique across levels
        dense_d = 0
    rng = np.random.default_rng(args.seed)
    sids = rng.integers(0, vocab, size=(args.constraints, L))
    if args.unconstrained:
        policy = DecodePolicy.unconstrained()
        logger.info("policy %s", policy.describe())
    else:
        t0 = time.time()
        tm = TransitionMatrix.from_sids(sids, vocab, dense_d=dense_d,
                                        device=device)
        rows_model = args.engine == "spmd" and args.spmd_rows == "model"
        plain = rows_model or args.impl == "plain"
        policy = DecodePolicy.static(tm, fused=args.fused,
                                     topk=not args.no_topk,
                                     impl="plain" if plain else None)
        logger.info("constraint index: %d states (%.2fs build); policy %s",
                    tm.n_states, time.time() - t0, policy.describe())
    params = transformer.init_params(cfg, seed=args.seed, device=device)
    if args.engine == "spmd":
        mesh = make_debug_mesh(model=2 if args.spmd_rows == "model" else 1)
        logger.info("SPMD mesh: %s over %d rank(s), CSR rows=%s",
                    dict(zip(mesh.mesh_dim_names, mesh.shape)),
                    mesh.size(), args.spmd_rows)
        r = SpmdRetriever(params, cfg, policy, L, vocab, beam_size=beam,
                          mesh=mesh, rows=args.spmd_rows)
    else:
        r = GenerativeRetriever(params, cfg, policy, L, vocab,
                                beam_size=beam)
    if continuous:
        beams, scores = serve_continuous(args, r, hist_len, rng, metrics,
                                         breaker)
    else:
        beams, scores = serve_batches(args, r, hist_len, rng, metrics)
    members, live = compliance(sorted_unique_sids(sids), beams, scores)
    logger.info("compliance: %s (%d/%d live beams in the constraint set)",
                members == live, members, live)
    logger.info("top-1 SIDs: %s", beams[:, 0, :].tolist())
    if injector is not None:
        logger.info("injected faults fired: %d", injector.n_fires())
    if args.metrics_json:
        metrics.write_snapshot(args.metrics_json)
        logger.info("metrics snapshot appended to %s", args.metrics_json)
    return 0 if members == live or args.unconstrained else 1


def serve_batches(args, r, hist_len, rng, metrics):
    """``StepTimer`` over ``retrieve`` (one warm-up, ``--requests`` trials,
    each in the ``step_wall_seconds{step="retrieve_batch"}`` histogram),
    then one more batch; returns its (beams, scores)."""
    hist = rng.integers(0, r.cfg.vocab_size, (args.batch, hist_len))
    timer = StepTimer("retrieve_batch", metrics, warmup=1,
                      trials=args.requests, device=r.device)
    stats = timer.measure(lambda: r.retrieve(hist))
    beams, scores = r.retrieve(hist)
    logger.info(
        "%.1f ms/request-batch of %d (beam %d, p99 %.1f ms, dispatch %.2f "
        "ms, steady specializations %d) on %s", stats.median * 1e3,
        args.batch, r.M, stats.p99 * 1e3, stats.dispatch_median * 1e3,
        stats.steady_compiles, r.device)
    return beams, scores


def serve_continuous(args, r, hist_len, rng, metrics, breaker):
    """``--requests * --batch`` requests through the continuous engine;
    returns the (beams, scores) of every completed request, stacked."""
    engine = ContinuousServingEngine(
        r, slots=args.batch, prompt_width=hist_len,
        prefill_chunk=max(args.batch // 2, 1), metrics=metrics,
        breaker=breaker)
    queue = RequestQueue()
    n_req = args.requests * args.batch
    pool = rng.integers(0, r.cfg.vocab_size, (max(n_req // 3, 1), hist_len))
    rids = [queue.submit(pool[i % len(pool)], r.L) for i in range(n_req)]
    t0 = time.perf_counter()
    results = engine.serve(queue)
    wall = time.perf_counter() - t0
    done = [i for i in rids if "sids" in results[i]]
    if len(done) < n_req:
        logger.info("degraded: %d/%d completed (%s)", len(done), n_req,
                    sorted({results[i].get("reason", "?") for i in rids
                            if "sids" not in results[i]}))
    if not done:
        raise SystemExit("no request completed")
    lat = np.array([results[i]["latency_s"] for i in done])
    hits = metrics.counter("serving_prefix_share_hits_total")
    logger.info(
        "continuous on %s: %d requests in %.1f ms (p50 %.1f ms, p99 %.1f "
        "ms); slot reuse %d, share hits prompt=%d mask_row=%d",
        r.device, len(done), wall * 1e3,
        float(np.quantile(lat, 0.5)) * 1e3,
        float(np.quantile(lat, 0.99)) * 1e3,
        int(metrics.counter("serving_slot_reuse_total").total()),
        int(hits.value(kind="prompt")), int(hits.value(kind="mask_row")))
    return (np.stack([results[i]["sids"] for i in done]),
            np.stack([results[i]["scores"] for i in done]))

if __name__ == "__main__":
    raise SystemExit(main())
