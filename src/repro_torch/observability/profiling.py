"""Host-side profiler annotations (counterpart of
``repro.observability.profiling.annotate``).

:func:`annotate` names a host region (a serve batch, a refresh rebuild) in a
``torch.profiler`` trace, so ``chip_smoke.py --profile`` shows the engine's
``serve_batch`` spans beside the kernels they launched.  It is
``torch.profiler.record_function``: with no profiler active it only pushes
and pops a record, and it does not fail.
"""
from __future__ import annotations

import torch

__all__ = ["annotate"]


def annotate(name: str):
    """Context manager naming the enclosed host region in a profiler trace."""
    return torch.profiler.record_function(name)
