"""Serving telemetry (DESIGN.md §9), the part the batch engine uses.

Counterpart of ``repro.observability`` without ``start_http_server`` and
``StepTimer`` (not ported yet).  Instrumentation stays on the host, around
device calls: results are bit-identical with telemetry on or off.
"""
from repro_torch.observability.metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    TOKEN_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.observability.profiling import annotate
from repro_torch.observability.timing import RecompileDetector, compile_events

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS_S",
    "TOKEN_LATENCY_BUCKETS_S",
    "RecompileDetector",
    "compile_events",
    "annotate",
    "record_policy",
]


def record_policy(registry: MetricsRegistry, policy, beams: int = 1) -> None:
    """Publish a DecodePolicy's static per-level plan as gauges.

    The plan is static metadata (it cannot change across hot swaps), so
    this runs once per policy install.  Gauges:

      * ``decode_level_backend_info{level,backend}`` = 1 — which backend
        masks each level (Prometheus "info" idiom);
      * ``decode_level_topk{level}`` — 1 iff the level takes the
        candidate-compressed branch (DESIGN.md §8), 0 for the dense
        vocab-aligned advance;
      * ``decode_level_candidate_width{level}`` — the per-beam top-C width
        at that level (0 on dense levels).
    """
    info = registry.gauge(
        "decode_level_backend_info",
        "constraint backend bound to each decode level (value always 1)")
    topk = registry.gauge(
        "decode_level_topk",
        "1 iff the level uses the candidate-compressed sparse branch")
    width = registry.gauge(
        "decode_level_candidate_width",
        "per-beam top-C candidate width at the level (0 = dense advance)")
    for row in policy.plan_info(beams):
        lvl = str(row["level"])
        info.set(1, level=lvl, backend=row["backend"])
        topk.set(int(row["topk"]), level=lvl)
        width.set(row["candidate_width"] if row["topk"] else 0, level=lvl)
