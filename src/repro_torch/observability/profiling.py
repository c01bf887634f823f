"""``torch.profiler`` integration: annotations and programmatic capture.

Counterpart of ``repro.observability.profiling``:

  * :func:`annotate` and :func:`named_scope` name a host region (a serve
    batch, a decode step, the cache reorder) in a profiler trace, so a
    trace shows the program's spans beside the kernels they launched.
    While a profiler records, a span is ``torch.profiler.record_function``:
    a kineto event on the same clock as the device's kernels.  With no
    profiler active it is one shared no-op context, which costs a check of
    the profiler's state and formats nothing.  :data:`SPANS` names every
    span the program opens.  (The reference's ``named_scope`` names HLO
    ops inside jitted code; the port has no trace-time scope, so the two
    are the same context here.)
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

__all__ = ["SPANS", "annotate", "named_scope", "trace_capture",
           "maybe_trace"]

# Every span the program opens.  A retrieve through ``ServingEngine`` opens
# ``serve_batch`` around the retriever's ``retrieve``, and inside it, as
# siblings that never overlap: ``prefill`` and ``cache_tile`` (the request
# cache tiled across the beams) once, per level of the search
# ``constraint_step`` and ``beam_select``, per decode step ``decode_step``
# and ``cache_reorder``, and ``device_fetch`` (the host blocked on the
# device's tokens and scores) last.  The SPMD and continuous engines name
# their batches ``spmd_serve_batch`` and ``continuous_step``.  Inside
# ``prefill`` and ``decode_step``, each mixture-of-experts layer's FFN is a
# span ``moe``.
SPANS = ("serve_batch", "prefill", "cache_tile", "decode_step",
         "constraint_step", "beam_select", "cache_reorder", "device_fetch",
         "spmd_serve_batch", "continuous_step", "moe")

_OFF = contextlib.nullcontext()


def _text(value) -> str:
    """A span argument as text: a string or number as is, an iterable as
    its items joined by commas."""
    if isinstance(value, (str, int, float)):
        return str(value)
    return ",".join(map(str, value))


def annotate(name: str, **args):
    """Context manager naming the enclosed host region in a profiler trace,
    with ``args`` recorded as ``"k=v ..."`` (a value that is an iterable,
    such as a generator of request ids, is read only while a profiler
    records).  With no profiler active: a shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    text = " ".join(f"{k}={_text(v)}" for k, v in args.items())
    return torch.profiler.record_function(name, text or None)


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
