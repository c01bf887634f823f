"""Host ms a retrieve spends selecting beams: the L ``beam_select`` spans (the
top-M over the beams' candidates and the new beam state)."""
from gpubench.metrics.retrieve_self_ms import span_ms


def read(rec):
    return span_ms(rec, "beam_select")
