"""The system contract: a system file supplies its configuration's weights,
a retrieve's work and the reference decoder, and the harness reaches all
three through it alone.  A system of the tests whose weights take a layout
that ``data.make_weights`` cannot make (``tiny/fused_system.py``) runs as a
cell from new files and entries alone."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from gpubench.calibrate import control_readings
from gpubench.harness import data, work
from gpubench.harness.runner import run_cell
from gpubench.harness.spec import SYSTEM_NAMES, Spec
from gpubench.harness.work import peak_flops
from gpubench.reference import decoder as reference_decoder
from gpubench.tests.tinyroot import TINY, make_root, one_thread

CPU = torch.device("cpu")
FUSED = "tiny-fused-b2"
READERS = {name: f'"""{name} (a test\'s metric)."""\n\n\n'
                 f'def read(rec):\n    return float(rec.{name[5:]})\n'
           for name in ("tiny_rounds", "tiny_window_s")}


def add_fused_cell(root):
    """The fused system, its configuration and a cell, as files and
    entries alone."""
    bench = root / "gpubench"
    shutil.copy(TINY / "fused_system.py", bench / "systems" / "tiny_fused.py")
    shutil.copy(TINY / "tiny-fused.json", bench / "configs" / "tiny-fused.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-fused", "source": "test",
                            "why": "test", "reduced": [],
                            "file": "gpubench/configs/tiny-fused.json"})
    spec["workloads"].append({"name": FUSED, "config": "tiny-fused",
                              "traffic": "closed-tiny", "chips": 1,
                              "why": "test"})
    for m in spec["per_layer"]:
        m["workloads"].append(FUSED)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root = add_fused_cell(make_root(tmp_path_factory.mktemp("root")))
    return Spec(root, root / "gpubench")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _passes(sysmod, cfg, traffic):
    s = cfg["search"]
    return sysmod.retrieve_passes(cfg["model"], traffic["batch"],
                                  s["beam_size"], s["max_len"] // 2,
                                  s["sid_length"])


def test_fused_cell_runs_from_files_alone(tmp_path):
    root = add_fused_cell(make_root(tmp_path, READERS))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gpubench import run\n"
        f"sys.exit(run.main(['--workload', {FUSED!r}, '--seed', '17', "
        "'--seconds', '0.3', '--trace', '1'], device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=240,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(root)})
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    # the model step's readers read the fused system's own count
    spec = Spec(root, root / "gpubench")
    cfg = spec.config("tiny-fused")
    traffic = spec.traffic("closed-tiny")
    mine = _passes(spec.system("tiny_fused"), cfg, traffic)
    dense = _passes(spec.system("gr_retrieval"), cfg, traffic)
    assert mine != dense
    got = {k: v["value"] for k, v in line["metrics"].items()}
    rounds, window_s = got["tiny_rounds"], got["tiny_window_s"]
    assert got["retrieve_mfu"] == pytest.approx(
        100.0 * sum(p.flops for p in mine) * rounds / window_s
        / peak_flops(cfg["model"]), rel=1e-12)
    assert got["retrieve_roofline_share"] == pytest.approx(
        100.0 * work.least_seconds(cfg["model"], mine) / (window_s / rounds),
        rel=1e-12)


@pytest.mark.parametrize("seed", [51, 2 ** 33 + 5])
def test_control_runs_through_the_system_decoder(spec, seed, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("the dense reference decoder was built")

    monkeypatch.setattr(reference_decoder.Decoder, "__init__", refused)
    limits = spec.config("tiny-fused")["check"]["limits"]
    readings = control_readings(spec, FUSED, seed, CPU)
    assert readings["bad_beams"] == 0  # the right sets, searched ...
    assert readings["score_gap"] > limits["score_gap"]  # ... in fp8


@pytest.mark.parametrize("missing", SYSTEM_NAMES)
def test_a_system_file_lacking_a_name_is_refused_at_load(spec, missing,
                                                         monkeypatch):
    kept = [n for n in SYSTEM_NAMES if n != missing]
    (spec.bench_dir / "systems" / "tiny_partial.py").write_text(
        f"from gpubench.systems.gr_retrieval import {', '.join(kept)}\n")
    with pytest.raises(ImportError, match=rf"tiny_partial\.py lacks {missing}$"):
        spec.system("tiny_partial")
    # a run is refused before set-up draws anything
    cfg = json.loads((TINY / "tiny-single.json").read_text())
    cfg["system"] = "tiny_partial"
    monkeypatch.setattr(spec, "config", lambda name: cfg)

    def drawn(*args, **kwargs):
        raise AssertionError("set-up drew from the seed")

    monkeypatch.setattr(data, "generator", drawn)
    with pytest.raises(ImportError, match=missing):
        run_cell(spec, "tiny-b2", 1, 0.2, False, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny-b2", "tiny-stacked-b4"])
@pytest.mark.parametrize("seed", [61, 2 ** 34 + 7])
def test_gr_retrieval_draws_and_counts_as_the_dense_helpers(spec, cell, seed,
                                                           monkeypatch):
    sysmod = spec.system("gr_retrieval")
    seen = {}

    class Capture(sysmod.System):
        def __init__(self, cfg, traffic, weights, *rest):
            seen["weights"] = weights
            super().__init__(cfg, traffic, weights, *rest)

    monkeypatch.setattr(sysmod, "System", Capture)
    monkeypatch.setattr(spec, "system", lambda name: sysmod)
    rec, readings, _, _ = run_cell(spec, cell, seed, 0.2, False, CPU,
                                   time.perf_counter())
    cfg = spec.config(spec.cell(cell)["config"])
    want = data.make_weights(cfg["model"], seed, CPU)
    assert seen["weights"].keys() == want.keys()
    for k, w in want.items():
        assert torch.equal(seen["weights"][k], w), k
    s = cfg["search"]
    assert rec.passes == work.retrieve_passes(
        cfg["model"], rec.traffic["batch"], s["beam_size"],
        s["max_len"] // 2, s["sid_length"])
    assert readings["bad_beams"] == 0
