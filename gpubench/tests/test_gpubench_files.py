"""A cell, a configuration, a traffic mix, a loop and a metric given as new
files and new ``BENCHMARK.json`` entries alone are found and run."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from gpubench.harness.spec import Spec
from gpubench.tests.tinyroot import TINY, make_root

ROUNDS = '''"""Rounds in the window (a test's metric)."""


def read(rec):
    return float(rec.rounds)
'''
NOTHING = '''"""A metric with nothing to read."""


def read(rec):
    return None
'''


ONE_BY_ONE = '''"""A loop of a test: one request a serve() call."""
import time

from gpubench.harness.runner import Window


def window(system, reqs, served, *, seconds=None, rounds=None):
    w = Window(start=time.perf_counter())
    while True:
        i = reqs.round()[0]
        t = time.perf_counter()
        out = system.serve(reqs.histories[[i]], [reqs.cid(i)])
        w.calls += 1
        w.attempted += 1
        w.latencies_s.append(time.perf_counter() - t)
        served.append({"history": reqs.histories[i], "cid": reqs.cid(i),
                       "pos": 0, **out[0]})
        w.seconds = time.perf_counter() - w.start
        if w.calls >= rounds if rounds is not None else w.seconds >= seconds:
            return w
'''


def _run(root, workload, seed, trace):
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gpubench import run\n"
        f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
        f"'{seed}', '--seconds', '0.3', '--trace', '{trace}'], "
        "device='cpu'))\n")
    return subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=240,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(root)})


def test_new_cell_and_metric_from_files_alone(tmp_path):
    root = make_root(tmp_path, {"tiny_rounds": ROUNDS, "tiny_nothing": NOTHING})
    p = _run(root, "tiny-b2", 11, 1)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["tiny_rounds"]["value"] >= 1.0
    assert line["metrics"]["tiny_rounds"]["unit"] == "%"
    assert "tiny_nothing" not in line["metrics"]  # nothing read: left out
    assert "window_s" in line["device"] and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the new configuration and traffic are what ran: B = 2 a round
    assert line["attempted"] % 2 == 0


def test_new_loop_from_files_alone(tmp_path):
    root = make_root(tmp_path, {"tiny_rounds": ROUNDS})
    (root / "gpubench" / "loops" / "tiny_one_by_one.py").write_text(
        ONE_BY_ONE)
    traffic = json.loads((TINY / "closed-tiny.json").read_text())
    traffic["loop"] = "tiny_one_by_one"
    (root / "gpubench" / "traffic" / "one-by-one-tiny.json").write_text(
        json.dumps(traffic))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-one", "config": "tiny-single",
                              "traffic": "one-by-one-tiny", "chips": 1,
                              "why": "test"})
    for m in spec["per_layer"]:
        m["workloads"].append("tiny-one")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    p = _run(root, "tiny-one", 13, 1)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    # one request a serve() call: the window's calls and both traces' 2 each
    calls = line["metrics"]["tiny_rounds"]["value"]
    assert line["attempted"] == calls + 2 * traffic["trace_rounds"]
    with pytest.raises(FileNotFoundError):  # a loop with no file is refused
        Spec(root, root / "gpubench").loop("open")


def test_trace_off_reports_the_end_to_end_metrics(tmp_path):
    root = make_root(tmp_path)
    p = _run(root, "tiny-b2", 12, 0)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    # peak memory is a device reading: absent on the CPU
    assert set(line["metrics"]) == {"requests_per_s", "request_p90_ms",
                                    "setup_s"}
    assert "breakdown" not in line and "busy_s" not in line["device"]
    assert set(line["checks"]) == {"bad_beams", "score_gap", "misselected"}
