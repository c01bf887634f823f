"""Host ms a retrieve spends on the KV cache's copies: the ``cache_tile`` span
(the request cache tiled across the beams) and the L - 1 ``cache_reorder``
spans (the call sites of ``kv_gather_ms``'s kernels)."""
from gpubench.metrics.retrieve_self_ms import span_ms


def read(rec):
    return span_ms(rec, "cache_tile", "cache_reorder")
