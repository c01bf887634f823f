"""A checkout root for CPU tests: a copy of ``gpubench/`` with tiny cells
added as files alone, ``BENCHMARK.json`` listing them, and ``src`` linked to
the port."""
from __future__ import annotations

import json
import pathlib
import shutil

import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent
TINY = BENCH / "tests" / "tiny"
CELLS = {"tiny-b2": ("tiny-single", "closed-tiny"),
         "tiny-stacked-b4": ("tiny-stacked", "closed-tiny-zipf")}


def make_root(tmp: pathlib.Path, extra_metrics: dict | None = None,
              limits: dict | None = None) -> pathlib.Path:
    """``tmp`` as a checkout root holding the tiny cells; ``extra_metrics``
    ({name: reader source}) adds per-layer metrics of the tiny cells;
    ``limits`` ({config: {number: limit}}) overrides check limits."""
    shutil.copytree(BENCH, tmp / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "src").symlink_to(REPO / "src")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg in ("tiny-single", "tiny-stacked"):
        data = json.loads((TINY / f"{cfg}.json").read_text())
        data["check"]["limits"].update((limits or {}).get(cfg, {}))
        (tmp / "gpubench" / "configs" / f"{cfg}.json").write_text(
            json.dumps(data))
        spec["configs"].append({"name": cfg, "source": "test", "why": "test",
                                "file": f"gpubench/configs/{cfg}.json",
                                "reduced": []})
    for traffic in ("closed-tiny", "closed-tiny-zipf"):
        shutil.copy(TINY / f"{traffic}.json",
                    tmp / "gpubench" / "traffic" / f"{traffic}.json")
    for name, (cfg, traffic) in CELLS.items():
        spec["workloads"].append({"name": name, "config": cfg,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    for m in spec["per_layer"]:
        m["workloads"] += list(CELLS)
    for name, source in (extra_metrics or {}).items():
        (tmp / "gpubench" / "metrics" / f"{name}.py").write_text(source)
        spec["per_layer"].append({
            "name": name, "unit": "%", "better": "higher",
            "source": "host_clock", "layer": "engine",
            "moves": "requests_per_s", "workloads": list(CELLS)})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


class one_thread:
    """Context: torch on one intra-op thread (the tests run beside others)."""

    def __enter__(self):
        self.saved = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.saved)
        return False
