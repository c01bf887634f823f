"""Device ms a retrieve spends gathering KV-cache rows: the cache tiled
across the beams and reordered after every step (``index_select``, which
runs as ATen's scatter-gather kernel or its index-select kernels)."""

MARKS = ("scattergather", "indexselect")


def read(rec):
    if rec.trace is None or not rec.trace_rounds:
        return None
    s = sum(v for name, v in rec.trace.device_s.items()
            if any(m in name.lower().replace("_", "") for m in MARKS))
    return s / rec.trace_rounds * 1e3 if s > 0 else None
