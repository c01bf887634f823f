"""Host ms a retrieve spends in the mixture-of-experts layers' feed-forward
calls: the program's ``moe`` spans (one per MoE layer in the prefill and in
every decode step), over the rounds traced with host ops.  A program
without the spans reads nothing."""


def read(rec):
    if rec.host_trace is None or not rec.trace_rounds:
        return None
    spans = rec.host_trace.spans.get("moe")
    return sum(spans) / rec.trace_rounds * 1e3 if spans else None
