"""Device ms a retrieve spends in GEMM kernels (cuBLAS ``nvjet``/``sm90``
kernels, CUTLASS, any name with ``gemm``)."""

MARKS = ("gemm", "nvjet", "cutlass", "xmma")


def read(rec):
    if rec.trace is None or not rec.trace_rounds:
        return None
    s = sum(v for name, v in rec.trace.device_s.items()
            if any(m in name.lower() for m in MARKS))
    return s / rec.trace_rounds * 1e3 if s > 0 else None
