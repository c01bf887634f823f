"""Port health and observability against the reference's contracts.

``start_http_server``'s ``/metrics`` (``tests/test_observability.py``), the
``/healthz`` / ``/readyz`` / ``/livez`` answers over a breaker and a
staleness source (``tests/test_reliability.py``), ``StepTimer``'s
warm-up/steady split over the port's specialization counter with the
reference's ``summary()`` keys, profiler capture, and the launcher's port
files.
"""
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.observability.timing import StepStats as JaxStepStats
from repro_torch.configs.base import TransformerConfig
from repro_torch.core import TransitionMatrix
from repro_torch.decoding import DecodePolicy
from repro_torch.launch import serve as launcher
from repro_torch.models import transformer
from repro_torch.observability import (
    MetricsRegistry,
    StepTimer,
    maybe_trace,
    named_scope,
    start_http_server,
    trace_capture,
)
from repro_torch.reliability import CircuitBreaker, HealthMonitor
from repro_torch.serving import GenerativeRetriever


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_metrics_endpoint():
    reg = MetricsRegistry()
    reg.counter("up_total").inc()
    server, port = start_http_server(reg, port=0)
    try:
        for path in ("/metrics", "/"):
            code, body = _get(port, path)
            assert code == 200 and "up_total 1" in body
        assert _get(port, "/nope")[0] == 404
        assert _get(port, "/healthz")[0] == 404  # no health callable
        assert _get(port, "/livez")[0] == 200
    finally:
        server.shutdown()
        server.server_close()


def test_healthz_endpoint_reflects_breaker_and_staleness():
    reg = MetricsRegistry()
    clock = {"t": 0.0}
    b = CircuitBreaker(now_fn=lambda: clock["t"], failure_threshold=3,
                       recovery_s=10.0, half_open_successes=2)
    stale = {"s": 0.0}
    health = HealthMonitor(breaker=b, staleness_fn=lambda: stale["s"],
                           staleness_bound_s=5.0, metrics=reg)
    server, port = start_http_server(reg, port=0, health=health)
    try:
        code, body = _get(port, "/healthz")
        assert code == 200 and json.loads(body)["ready"] is True
        assert _get(port, "/livez")[0] == 200
        assert "serving_ready 1" in _get(port, "/metrics")[1]

        for _ in range(3):
            b.record_failure()
        code, body = _get(port, "/healthz")
        payload = json.loads(body)
        assert code == 503 and payload["reasons"] == ["breaker_open"]
        assert _get(port, "/livez")[0] == 200
        clock["t"] = 10.0
        b.allow()
        b.record_success()
        b.record_success()
        stale["s"] = 30.0  # degraded past the bound: stale, not dead
        code, body = _get(port, "/readyz")
        payload = json.loads(body)
        assert code == 503 and payload["reasons"] == ["stale_constraints"]
        assert payload["constraint_staleness_seconds"] == 30.0
        stale["s"] = 1.0  # degraded-but-serving stays ready
        assert _get(port, "/healthz")[0] == 200
        assert _get(port, "/livez")[0] == 200  # liveness never flips
    finally:
        server.shutdown()
        server.server_close()


def _retriever():
    V, L = 32, 3
    cfg = TransformerConfig(
        name="tiny", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=V, dtype="float32", attn_chunk_q=8,
        attn_chunk_kv=8)
    sids = np.random.default_rng(0).integers(0, V, (200, L))
    tm = TransitionMatrix.from_sids(sids, V, dense_d=1, device="cpu")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    return GenerativeRetriever(params, cfg, DecodePolicy.static(tm), L, V,
                               beam_size=4)


def test_step_timer_splits_warmup_and_steady_specializations():
    reg = MetricsRegistry()
    r = _retriever()
    hist = np.random.default_rng(1).integers(0, 32, (2, 6))
    timer = StepTimer("t", reg, warmup=2, trials=5, device="cpu")
    stats = timer.measure(r.retrieve, hist)  # the first call specializes
    assert stats.trials == 5
    assert stats.warmup_compiles == 1
    assert stats.steady_compiles == 0
    assert 0 < stats.median < 10.0 and stats.p99 >= stats.p50
    assert (stats.dispatch_s <= stats.wall_s).all()
    assert reg.histogram("step_wall_seconds").count(step="t") == 5
    assert reg.histogram("step_dispatch_seconds").count(step="t") == 5
    c = reg.counter("step_compiles_total")
    assert c.value(step="t", phase="warmup") == 1
    assert c.value(step="t", phase="steady") == 0
    want = JaxStepStats("t", np.ones(2), np.ones(2), 0, 0).summary()
    assert stats.summary().keys() == want.keys()
    # a new history shape specializes again: counted as steady
    stats = StepTimer("u", reg, warmup=0, trials=2, device="cpu").measure(
        r.retrieve, hist[:1])
    assert stats.steady_compiles == 1
    with pytest.raises(ValueError):
        StepTimer(trials=0)


def test_maybe_trace_none_is_a_noop_and_capture_writes_a_trace(tmp_path):
    with maybe_trace(None) as d:
        assert d is None
    out = tmp_path / "trace"
    with maybe_trace(str(out)) as d:
        assert d == str(out)
        with named_scope("decode_step"):
            torch.ones(8).sum()
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    body = (out / files[0]).read_text()
    assert len(body) > 0 and "decode_step" in body
    with trace_capture(str(tmp_path / "again")):
        pass
    assert os.listdir(tmp_path / "again")


def test_launcher_writes_its_port_files(tmp_path):
    mp, hp = tmp_path / "metrics.port", tmp_path / "health.port"
    js = tmp_path / "metrics.jsonl"
    argv = ["--config", "small", "--constraints", "500", "--batch", "2",
            "--beam", "4", "--requests", "2", "--device", "cpu",
            "--metrics-port-file", str(mp), "--health-port-file", str(hp),
            "--metrics-json", str(js)]
    assert launcher.main(argv) == 0
    port = int(mp.read_text())
    assert port > 0 and int(hp.read_text()) == port
    snap = json.loads(js.read_text().strip().splitlines()[-1])
    cell = snap["histograms"]["step_wall_seconds"]['{step="retrieve_batch"}']
    assert cell["count"] == 2  # StepTimer's trials
    assert "serving_ready" in snap["gauges"]  # the HealthMonitor's gauge
