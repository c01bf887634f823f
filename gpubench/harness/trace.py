"""What a ``--trace 1`` run reads from ``torch.profiler``.

:class:`Trace` records the enclosed rounds, then reduces the events to:
device seconds by name, the union of the device's busy intervals, the
traced window's length, the durations of the program's spans by name, and
the idle gaps labelled by the host event that was running through each (the
innermost one covering the gap's middle).  With ``host=False`` it records
device activity alone (and the CUDA runtime calls that launch it), which
costs the host far less than recording every host op: the device's numbers
come from such a trace, the spans and the gaps' host ops from one with
``host=True``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Trace"]

NAME_CHARS = 160  # kernel names are cut to this length in the breakdown
LABELLED_GAPS = 400  # the longest gaps that get a host label
PROFILER_EVENTS = {"Activity Buffer Request"}  # the profiler's own work


class Trace:
    """Context manager: profile the block; afterwards the reductions are
    attributes (``device_s``: {name: seconds}, ``busy_s``, ``window_s``,
    ``spans``: {name: [seconds]}, ``idle_by_host``: {label: seconds})."""

    def __init__(self, device: torch.device, host: bool = True):
        self.device = device
        self.host = host

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = ([ProfilerActivity.CPU]
                if self.host or self.device.type != "cuda" else [])
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce(self._prof.profiler.kineto_results.events())
        del self._prof
        return False

    def _reduce(self, events) -> None:
        from torch.autograd import DeviceType

        dev_type = (DeviceType.CUDA if self.device.type == "cuda"
                    else DeviceType.CPU)
        dev_names, dev_iv, host_names, host_iv, spans = [], [], [], [], {}
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CPU:
                if e.name() in PROFILER_EVENTS:
                    continue
                host_names.append(e.name())
                host_iv.append((start, start + dur))
                if e.is_user_annotation():
                    spans.setdefault(e.name(), []).append(dur * 1e-9)
            if (e.device_type() == dev_type == DeviceType.CUDA
                    and not e.is_user_annotation()):  # a span, not work
                dev_names.append(e.name())
                dev_iv.append((start, start + dur))
        self.spans = spans
        self.device_s = {}
        for name, (a, b) in zip(dev_names, dev_iv):
            self.device_s[name] = self.device_s.get(name, 0.0) + (b - a) * 1e-9
        self.busy_s, gaps = _union(np.asarray(dev_iv, np.int64).reshape(-1, 2))
        self.idle_by_host = _label_gaps(gaps, host_names,
                                        np.asarray(host_iv, np.int64))

    def breakdown(self) -> dict:
        """The contract's ``breakdown``: the ten device ops with the most
        time and the ten host ops under the most idle time, in seconds."""
        def top(d):
            return [[k[:NAME_CHARS], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.device_s),
                "idle_gaps": top(self.idle_by_host)}


def _union(iv: np.ndarray):
    """(busy seconds, gaps (G, 2) ns) of intervals (N, 2) ns."""
    if iv.shape[0] == 0:
        return 0.0, np.zeros((0, 2), np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new run starts where an interval begins after every earlier end
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    run_end = np.concatenate([ends[np.flatnonzero(new)[1:] - 1], [ends[-1]]])
    busy = float((run_end - starts).sum()) * 1e-9
    gaps = np.stack([run_end[:-1], starts[1:]], axis=1)
    return busy, gaps


def _label_gaps(gaps: np.ndarray, names: list, iv: np.ndarray) -> dict:
    """Idle seconds of the longest gaps, summed by the innermost host op
    covering each gap's middle ("(no host op)" where none does)."""
    out: dict = {}
    if gaps.shape[0] == 0:
        return out
    dur = gaps[:, 1] - gaps[:, 0]
    for g in np.argsort(-dur, kind="stable")[:LABELLED_GAPS]:
        mid = (gaps[g, 0] + gaps[g, 1]) // 2
        label = "(no host op)"
        if iv.shape[0]:
            cover = np.flatnonzero((iv[:, 0] <= mid) & (iv[:, 1] >= mid))
            if cover.size:
                label = names[cover[np.argmax(iv[cover, 0])]]
        out[label] = out.get(label, 0.0) + float(dur[g]) * 1e-9
    return out
