"""Host milliseconds a batch spends in the engine outside the program's
``serve_batch`` span: the benchmark's clock around ``serve()`` minus the
span's duration, over the rounds traced with host ops (one batch a
round)."""


def read(rec):
    if rec.host_trace is None or not rec.trace_rounds:
        return None
    spans = rec.host_trace.spans.get("serve_batch", [])
    if len(spans) != rec.trace_rounds:
        return None
    return (rec.trace_serve_s - sum(spans)) / rec.trace_rounds * 1e3
