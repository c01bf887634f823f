"""Device ms a retrieve spends in the routed experts' grouped products (the
kernels behind ``torch._grouped_mm``, CUTLASS's grouped GEMMs, whose names
hold ``GroupProblemShape``), in the prefill and every decode step.  A
program without them reads nothing."""

MARKS = ("groupproblemshape", "grouped")


def read(rec):
    if rec.trace is None or not rec.trace_rounds:
        return None
    s = sum(v for name, v in rec.trace.device_s.items()
            if any(m in name.lower() for m in MARKS))
    return s / rec.trace_rounds * 1e3 if s > 0 else None
