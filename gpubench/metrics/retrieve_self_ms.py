"""Host ms a retrieve spends in the retriever's and the search's own Python
(the specialization key, the id checks, the history's upload, the search's
set-up and the code between its levels): the program's ``serve_batch`` span
less the seven spans inside it.  The other five readers of those spans
take :func:`span_ms` from here, so the six add up to the ``serve_batch``
span.  Each reads ms a round of the host trace: one retrieve in a closed
loop, which drains each round with one ``serve()`` call."""

INNER = ("prefill", "cache_tile", "decode_step", "constraint_step",
         "beam_select", "cache_reorder", "device_fetch")


def counts(L: int) -> dict:
    """The spans a retrieve of SID length ``L`` opens inside
    ``serve_batch``, by name (the prefill's logits stand in for step 0)."""
    return dict(zip(INNER, (1, 1, L - 1, L, L, L - 1, 1)))


def span_ms(rec, *names):
    """Host ms a round in the spans ``names``, summed over the host trace's
    rounds; ``None`` unless ``serve_batch`` appears once a round and every
    span inside it at its count (a program without these spans, or a
    miscount, reads as nothing)."""
    if rec.host_trace is None or not rec.trace_rounds:
        return None
    spans, n = rec.host_trace.spans, rec.trace_rounds
    if len(spans.get("serve_batch", ())) != n:
        return None
    for name, c in counts(rec.cfg["search"]["sid_length"]).items():
        if len(spans.get(name, ())) != c * n:
            return None
    return sum(sum(spans[k]) for k in names) / n * 1e3


def read(rec):
    total = span_ms(rec, "serve_batch")
    return None if total is None else total - span_ms(rec, *INNER)
