"""The six per-layer metrics that read the program's spans: a traced tiny
run reports each, and they add up to the ``serve_batch`` span; a program
without the spans, or a miscount, reads as nothing and raises nothing."""
from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from gpubench.harness.result import result_line
from gpubench.harness.runner import run_cell
from gpubench.harness.spec import Spec
from gpubench.tests.tinyroot import REPO, make_root, one_thread

SIX = ("decoder_host_ms", "constraint_host_ms", "beam_select_host_ms",
       "kv_host_ms", "device_wait_ms", "retrieve_self_ms")

# the run's own result line, and the per-round ``serve_batch`` span beside it
SPY = '''
import json, sys
from gpubench.harness import result

line_of = result.result_line


def spy(spec, cell, rec, *args):
    out = line_of(spec, cell, rec, *args)
    sb = rec.host_trace.spans["serve_batch"]
    print(json.dumps({"serve_batch_ms": sum(sb) / rec.trace_rounds * 1e3}),
          file=sys.stderr)
    return out


result.result_line = spy
'''


@pytest.mark.parametrize("cell", ["tiny-b2", "tiny-stacked-b4"])
def test_a_traced_run_reports_six_metrics_that_add_up(tmp_path, cell):
    root = make_root(tmp_path)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        f"{SPY}\n"
        "from gpubench import run\n"
        f"sys.exit(run.main(['--workload', {cell!r}, '--seed', "
        "'2147483659', '--seconds', '0.3', '--trace', '1'], "
        "device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=240,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(root)})
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    spy = json.loads(next(s for s in p.stderr.splitlines()
                          if s.startswith('{"serve_batch_ms"')))
    assert line["correct"] is True
    values = [line["metrics"][m]["value"] for m in SIX]
    assert all(v >= 0 for v in values), values
    assert all(line["metrics"][m]["unit"] == "ms" for m in SIX)
    assert sum(values) == pytest.approx(spy["serve_batch_ms"], rel=0.01)
    assert "engine_host_ms" in line["metrics"]


def test_a_program_without_the_spans_reads_nothing(tmp_path, monkeypatch):
    """The parent program opens ``serve_batch`` alone: the six metrics are
    left out of its line, and the rest of the line stands."""
    import contextlib
    import importlib

    for mod in ("repro_torch.core.beam_search",
                "repro_torch.serving.generative_retrieval"):
        monkeypatch.setattr(importlib.import_module(mod), "annotate",
                            lambda name, **a: contextlib.nullcontext())
    root = make_root(tmp_path)
    spec = Spec(root, root / "gpubench")
    cpu = torch.device("cpu")
    with one_thread():
        rec, readings, attempted, failed = run_cell(
            spec, "tiny-b2", 3, 0.2, True, cpu, time.perf_counter())
    line, _ = result_line(spec, spec.cell("tiny-b2"), rec, readings,
                          attempted, failed, True, cpu)
    assert line["correct"] is True
    assert not set(SIX) & set(line["metrics"])
    assert "engine_host_ms" in line["metrics"]


def _rec(counts: dict, L: int = 4, rounds: int = 2):
    spans = {k: [0.001] * n for k, n in counts.items()}
    return SimpleNamespace(
        host_trace=SimpleNamespace(spans=spans), trace_rounds=rounds,
        cfg={"search": {"sid_length": L}})


def test_a_miscount_reads_as_nothing():
    spec = Spec(REPO)
    readers = {m: spec.reader(m) for m in SIX}
    L, n = 4, 2
    good = {"serve_batch": n, "prefill": n, "cache_tile": n,
            "decode_step": (L - 1) * n, "constraint_step": L * n,
            "beam_select": L * n, "cache_reorder": (L - 1) * n,
            "device_fetch": n}
    # 1 ms each: the prefill and L - 1 decode steps a round
    assert readers["decoder_host_ms"].read(_rec(good)) == pytest.approx(L)
    for name in good:
        for off in (-1, 1):
            bad = dict(good, **{name: good[name] + off})
            assert all(r.read(_rec(bad)) is None for r in readers.values())
    assert all(r.read(SimpleNamespace(host_trace=None, trace_rounds=0))
               is None for r in readers.values())


def test_the_readers_name_the_programs_spans():
    from repro_torch.observability import SPANS

    spec = Spec(REPO)
    inner = spec.reader("retrieve_self_ms").INNER
    assert set(inner) | {"serve_batch"} <= set(SPANS)
