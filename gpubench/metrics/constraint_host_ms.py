"""Host ms a retrieve spends in the constraint step: the L ``constraint_step``
spans (the policy's masked advance, the paper's overhead seen from the
host)."""
from gpubench.metrics.retrieve_self_ms import span_ms


def read(rec):
    return span_ms(rec, "constraint_step")
