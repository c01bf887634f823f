"""Host ms a retrieve waits for the device at its end: the ``device_fetch``
span around the copy of the beams' tokens and scores to the host."""
from gpubench.metrics.retrieve_self_ms import span_ms


def read(rec):
    return span_ms(rec, "device_fetch")
