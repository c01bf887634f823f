"""The routed experts' least time a retrieve over ``expert_gemm_ms``, in %.
The least time is the larger of the hit experts' weights read once and each
assignment's row read and written, at 3.35 TB/s, and of their operations at
the dtype's peak, summed over a retrieve's MoE layer-passes at the routing
counter's means (``systems/gr_mla_moe.py``'s ``expert_least_seconds``; the
counter is the port's ``repro_torch.models.moe.routing_counts``, kept while
the profiler records).  Nothing is read without the counter or the kernels."""
from gpubench.metrics import expert_gemm_ms


def routing_counts(rec):
    """The port's routing counts where it keeps them and they hold prefill
    and decode passes; ``None`` otherwise."""
    if rec.trace is None:
        return None
    from repro_torch.models import moe

    read = getattr(moe, "routing_counts", None)
    counts = read() if read is not None else {}
    if not all(counts.get(p, {}).get("passes") for p in ("prefill", "decode")):
        return None
    return counts


def read(rec):
    counts = routing_counts(rec)
    gemm_ms = expert_gemm_ms.read(rec)
    if counts is None or gemm_ms is None:
        return None
    from gpubench.systems.gr_mla_moe import expert_least_seconds

    least = expert_least_seconds(rec.cfg["model"], counts,
                                 rec.cfg["search"]["sid_length"])
    return 100.0 * least / (gemm_ms * 1e-3)
