"""Device ms a retrieve spends in copy kernels (``direct_copy``: the
permuted KV copies of decode attention and other layout copies)."""


def read(rec):
    if rec.trace is None or not rec.trace_rounds:
        return None
    s = sum(v for name, v in rec.trace.device_s.items()
            if "direct_copy" in name)
    return s / rec.trace_rounds * 1e3 if s > 0 else None
