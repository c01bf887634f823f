"""Device ms a retrieve spends in the decode-attention kernel (every kernel
whose name contains ``decode_attn``: the port's hand-written decode
attention, on either of its routes).  A program without the kernel reads
nothing."""


def read(rec):
    if rec.trace is None or not rec.trace_rounds:
        return None
    s = sum(v for name, v in rec.trace.device_s.items() if "decode_attn" in name)
    return s / rec.trace_rounds * 1e3 if s > 0 else None
