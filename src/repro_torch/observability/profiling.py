"""``torch.profiler`` integration: annotations and programmatic capture.

Counterpart of ``repro.observability.profiling``:

  * :func:`annotate` and :func:`named_scope` name a host region (a serve
    batch, a refresh rebuild, a decode phase) in a profiler trace, so
    ``chip_smoke.py --profile`` shows the engine's ``serve_batch`` spans
    beside the kernels they launched.  Both are
    ``torch.profiler.record_function``: with no profiler active it only
    pushes and pops a record, and it does not fail.  (The reference's
    ``named_scope`` names HLO ops inside jitted code; the port has no
    trace-time scope, so the two are the same context here.)
  * :func:`trace_capture` records the enclosed region with
    ``torch.profiler.profile`` (CPU, and CUDA when a card is present) and
    exports a Chrome trace into the directory given (open it with Perfetto
    or ``chrome://tracing``); :func:`maybe_trace` makes it flag-friendly:
    ``None`` disables capture with no overhead.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["annotate", "named_scope", "trace_capture", "maybe_trace"]


def annotate(name: str):
    """Context manager naming the enclosed host region in a profiler trace."""
    return torch.profiler.record_function(name)


named_scope = annotate


@contextlib.contextmanager
def trace_capture(log_dir: str):
    """Capture a profiler trace of the enclosed region into ``log_dir``
    (``trace-<pid>-<ns>.json``); yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def maybe_trace(log_dir: Optional[str]):
    """``trace_capture(log_dir)`` when a directory is given, else a no-op
    context — the shape CLI flags want (``--trace-dir`` defaulting off)."""
    if log_dir:
        return trace_capture(log_dir)
    return contextlib.nullcontext()
