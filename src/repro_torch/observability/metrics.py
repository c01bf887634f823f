"""Low-overhead serving metrics: counters, gauges, fixed-bucket histograms.

A copy of ``repro.observability.metrics``, HTTP exposition
(:func:`start_http_server`) included; it is host-only Python, so the two
render the same Prometheus text for the same operations.

The paper's headline claim is an *overhead* claim (0.033 ms per constrained
step, 0.25% of inference time), so the telemetry that measures the serving
stack must itself be cheap enough to leave on in production shape.  Design
rules (DESIGN.md §9):

  * **Host-side only.**  Metrics are recorded around device calls, never
    inside them.  Nothing in this module touches a tensor; device work is
    bit-identical with metrics on or off.
  * **Lock-cheap.**  One ``threading.Lock`` per metric, held only for a
    dict lookup plus a scalar add (no allocation on the hot path once a
    label set exists).  Histograms are numpy ``int64`` bucket-count arrays
    with *fixed* bucket edges — an observation is one ``bisect`` plus one
    element increment, O(1) and allocation-free.
  * **Labeled.**  Every metric accepts ``**labels`` (backend, constraint
    slot / tenant lane, refresh kind, ...).  A label set is a sorted
    key-value tuple; cells are created on first use and live forever (label
    cardinality is operator-controlled: slot ids and backend names, not
    request ids).

Export sinks:

  * :meth:`MetricsRegistry.render_prometheus` — Prometheus text exposition
    (format 0.0.4: ``# TYPE`` headers, cumulative ``_bucket{le=...}``
    rows, ``_sum``/``_count``), servable via :func:`start_http_server`
    (``/metrics``, with ``/healthz``, ``/readyz`` and ``/livez``).
  * :meth:`MetricsRegistry.write_snapshot` — one JSON object per line
    (JSON-lines), appended so periodic snapshots form a time series.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time
from bisect import bisect_left
from typing import Optional

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS_S",
    "TOKEN_LATENCY_BUCKETS_S",
    "start_http_server",
]

# Geometric latency buckets: 25 us .. ~13 min, x2 per bucket.  Wide enough
# for a CPU-container smoke run and a real accelerator step in the same
# catalog; 26 fixed edges keep every histogram cell at 27 int64 counts.
DEFAULT_LATENCY_BUCKETS_S = tuple(2.5e-5 * 2.0 ** i for i in range(26))

# Finer preset for per-token quantities (TTFT, time-per-output-token): the
# interesting range sits well below a request latency, so start at 5 us and
# stop around 40 s instead of stretching to minutes.
TOKEN_LATENCY_BUCKETS_S = tuple(5.0e-6 * 2.0 ** i for i in range(24))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _label_key(labels: dict) -> tuple:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2 ** 53 else repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self._cells: dict = {}

    def labeled(self) -> list:
        """[(label_key_tuple, cell_value), ...] — a consistent snapshot."""
        with self._lock:
            return list(self._cells.items())


class Counter(_Metric):
    """Monotonically increasing float (Prometheus ``counter``)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._cells.get(_label_key(labels), 0.0)

    def total(self) -> float:
        """Sum over every label set (convenience for invariant asserts)."""
        with self._lock:
            return float(sum(self._cells.values()))


class Gauge(_Metric):
    """Set-to-current-value metric (queue depth, occupancy, headroom)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = float(value)

    def add(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._cells.get(_label_key(labels), 0.0)


class _HistCell:
    __slots__ = ("counts", "sum")

    def __init__(self, n_buckets: int):
        self.counts = np.zeros(n_buckets + 1, dtype=np.int64)  # +overflow
        self.sum = 0.0


class Histogram(_Metric):
    """Fixed-bucket histogram; observations are O(1), quantiles are derived.

    Bucket semantics match Prometheus: edge ``b[i]`` is the *inclusive*
    upper bound of bucket ``i``; the final implicit bucket is ``+Inf``.
    ``quantile`` interpolates linearly inside the winning bucket (the
    standard ``histogram_quantile`` estimator), so p50/p99 are estimates
    bounded by the bucket edges — exact enough for SLO dashboards; the
    load-generator keeps exact per-request samples where exactness matters.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_LATENCY_BUCKETS_S):
        super().__init__(name, help)
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("buckets must be strictly increasing, non-empty")
        self.buckets = b

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        i = bisect_left(self.buckets, value)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistCell(len(self.buckets))
            cell.counts[i] += 1
            cell.sum += value

    def count(self, **labels) -> int:
        with self._lock:
            cell = self._cells.get(_label_key(labels))
            return int(cell.counts.sum()) if cell is not None else 0

    def sum(self, **labels) -> float:
        with self._lock:
            cell = self._cells.get(_label_key(labels))
            return float(cell.sum) if cell is not None else 0.0

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile estimate (NaN when empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            cell = self._cells.get(_label_key(labels))
            counts = cell.counts.copy() if cell is not None else None
        if counts is None or counts.sum() == 0:
            return float("nan")
        total = int(counts.sum())
        target = q * total
        cum = np.cumsum(counts)
        i = int(np.searchsorted(cum, max(target, 1), side="left"))
        if i >= len(self.buckets):  # overflow bucket: clamp to top edge
            return self.buckets[-1]
        lo = self.buckets[i - 1] if i > 0 else 0.0
        hi = self.buckets[i]
        below = int(cum[i - 1]) if i > 0 else 0
        frac = (target - below) / max(int(counts[i]), 1)
        return lo + (hi - lo) * min(max(frac, 0.0), 1.0)


class MetricsRegistry:
    """Named metric store; get-or-create accessors are idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_LATENCY_BUCKETS_S) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self) -> list:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    # -- sinks ---------------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: list[str] = []
        for m in self.metrics():
            if m.help:
                out.append(f"# HELP {m.name} {_escape(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for key, cell in sorted(m.labeled()):
                    cum = 0
                    for edge, c in zip(m.buckets, cell.counts):
                        cum += int(c)
                        le = _fmt_labels(key, f'le="{_fmt_value(edge)}"')
                        out.append(f"{m.name}_bucket{le} {cum}")
                    cum += int(cell.counts[-1])
                    le = _fmt_labels(key, 'le="+Inf"')
                    out.append(f"{m.name}_bucket{le} {cum}")
                    out.append(
                        f"{m.name}_sum{_fmt_labels(key)} "
                        f"{_fmt_value(cell.sum)}"
                    )
                    out.append(f"{m.name}_count{_fmt_labels(key)} {cum}")
            else:
                for key, v in sorted(m.labeled()):
                    out.append(f"{m.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-serializable state: exact counters/gauges, histogram
        count/sum plus p50/p90/p99 bucket estimates."""
        snap: dict = {"ts": time.time(), "counters": {}, "gauges": {},
                      "histograms": {}}
        for m in self.metrics():
            if isinstance(m, Histogram):
                cells = {}
                for key, cell in m.labeled():
                    counts = cell.counts
                    total = int(counts.sum())
                    labels = dict(key)
                    entry = {"count": total, "sum": float(cell.sum)}
                    if total:
                        entry.update(
                            p50=m.quantile(0.5, **labels),
                            p90=m.quantile(0.9, **labels),
                            p99=m.quantile(0.99, **labels),
                        )
                    cells[_fmt_labels(key) or ""] = entry
                snap["histograms"][m.name] = cells
            else:
                kind = "counters" if isinstance(m, Counter) else "gauges"
                snap[kind][m.name] = {
                    _fmt_labels(key) or "": v for key, v in m.labeled()
                }
        return snap

    def write_snapshot(self, path, mode: str = "a") -> dict:
        """Append one JSON-lines snapshot record to ``path``; returns it."""
        snap = self.snapshot()
        with open(path, mode) as f:
            f.write(json.dumps(snap, sort_keys=True) + "\n")
        return snap


def start_http_server(registry: MetricsRegistry, port: int = 0,
                      host: str = "127.0.0.1", health=None):
    """Serve ``registry.render_prometheus()`` at ``/metrics`` on a daemon
    thread; returns ``(server, bound_port)``.  ``port=0`` binds an ephemeral
    port — ``launch/serve.py --metrics-port-file`` writes it out so a
    scraper (or a test) can discover the endpoint.  Shut down with
    ``server.shutdown()``.

    ``health`` (optional) is a callable ``() -> (ready, payload_dict)`` —
    typically a :class:`repro_torch.reliability.HealthMonitor` — served at
    ``/healthz`` (200 when ready, 503 otherwise, JSON body either way).
    ``/livez`` always answers 200: the process is alive exactly when it
    can answer at all (DESIGN.md §13).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status: int, body: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            path = self.path.split("?")[0]
            if path == "/livez":
                self._reply(200, b"ok\n", "text/plain; charset=utf-8")
                return
            if path in ("/healthz", "/readyz") and health is not None:
                ready, payload = health()
                body = (json.dumps(payload, sort_keys=True) + "\n").encode()
                self._reply(200 if ready else 503, body, "application/json")
                return
            if path not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = registry.render_prometheus().encode()
            self._reply(200, body,
                        "text/plain; version=0.0.4; charset=utf-8")

        def log_message(self, *a):  # quiet: scrapes are not serving events
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="metrics-exposition")
    t.start()
    return server, int(server.server_address[1])
