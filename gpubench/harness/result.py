"""The result line of a run, and the check lines printed beside it."""
from __future__ import annotations

import torch

__all__ = ["result_line"]


def _device(rec, trace: bool, dev: torch.device) -> dict:
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": rec.peak_bytes}
    if trace:
        out["busy_s"] = rec.trace.busy_s
        out["window_s"] = rec.trace.window_s
    return out


def result_line(spec, cell: dict, rec, readings: dict, attempted: int,
                failed: int, trace: bool, dev: torch.device) -> tuple:
    """(the result object, the check lines for standard error)."""
    metrics = {}
    for m in spec.metrics(cell["name"], trace):
        value = spec.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = rec.cfg["check"]["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = (failed == 0 and attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": _device(rec, trace, dev)}
    if trace:
        line["breakdown"] = {
            "device_ops": rec.trace.breakdown()["device_ops"],
            "idle_gaps": rec.host_trace.breakdown()["idle_gaps"]}
    line["checks"] = checks
    lines = [f"phase {k}: {v:.3f} s" for k, v in rec.phases.items()]
    lines.append(f"window: {rec.rounds} rounds, {rec.requests} requests in "
                 f"{rec.window_s:.3f} s")
    if trace:
        for t, what in ((rec.trace, "device"), (rec.host_trace, "host")):
            lines.append(f"trace ({what}): {rec.trace_rounds} rounds in "
                         f"{t.window_s:.3f} s, device busy {t.busy_s:.3f} s")
    lines += [f"check {k}: {c['value']} (limit {c['limit']})"
              for k, c in checks.items()]
    lines.append(f"check failed_requests: {failed} (limit 0)")
    return line, lines
