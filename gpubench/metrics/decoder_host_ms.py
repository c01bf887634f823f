"""Host ms a retrieve spends in the decoder's calls: the ``prefill`` span and
the L - 1 ``decode_step`` spans (the host's side of the model's launches)."""
from gpubench.metrics.retrieve_self_ms import span_ms


def read(rec):
    return span_ms(rec, "prefill", "decode_step")
