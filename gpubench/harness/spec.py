"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them.

* a cell: ``workloads[]`` by ``name``;
* its configuration: the file ``configs[].file`` names (JSON), whose
  ``system`` names ``gpubench/systems/<system>.py`` (see below);
* its traffic: ``gpubench/traffic/<traffic>.json``, whose ``loop`` names
  ``gpubench/loops/<loop>.py`` (how the window issues requests);
* a metric: ``gpubench/metrics/<name>.py``, whose ``read(record)`` returns
  the value or ``None`` where it finds nothing to read.

A system file owns everything that depends on the model's architecture.
It defines (:data:`SYSTEM_NAMES`; :meth:`Spec.system` refuses a file that
lacks any of them, before set-up draws anything):

* ``make_weights(model, seed, device) -> dict``: the configuration's
  weights in a layout of the system's choosing, drawn from
  ``data.generator(seed, "weights", device)``;
* ``retrieve_passes(model, B, M, S, L) -> list[work.Pass]``: the operations
  and least bytes of one retrieve of ``B`` requests, ``M`` beams, histories
  of ``S`` tokens and SIDs of ``L`` (what ``retrieve_mfu`` and
  ``retrieve_roofline_share`` read);
* ``decoder(weights, model, precision)``: the plain reference over those
  weights, in ``"float32"`` (the reference) or ``"fp8"`` (the control of
  ``calibrate.py``): an object with ``device``, ``history(tokens)`` (whose
  result has ``last_logits``) and ``suffix_logits(hist, suffix,
  last_only)``, as :class:`gpubench.reference.decoder.Decoder`;
* ``System(cfg, traffic, weights, catalog, meta, device)``: the program
  under test, with ``serve``, ``launches``, ``index_bytes`` and ``close``;
* ``judge(cfg, weights, catalog, meta, served, sample) -> dict``: the
  numbers compared with the configuration's ``check.limits``.

A later cell, configuration, system, traffic, loop or metric is a new file
and a new entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

__all__ = ["Spec", "SYSTEM_NAMES"]

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
SYSTEM_NAMES = ("System", "judge", "make_weights", "retrieve_passes",
                "decoder")


def _safe(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _module(path: pathlib.Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: pathlib.Path, bench_dir: pathlib.Path = BENCH_DIR):
        self.root = pathlib.Path(root)
        self.bench_dir = pathlib.Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json")
                          .read_text())

    def loop(self, name: str):
        return _module(self.bench_dir / "loops" / f"{name}.py",
                       f"gpubench_loop_{_safe(name)}")

    def system(self, name: str):
        """The system file ``name``, refused (``ImportError``) where it
        lacks a name of the contract."""
        path = self.bench_dir / "systems" / f"{name}.py"
        mod = _module(path, f"gpubench_system_{name}")
        missing = [n for n in SYSTEM_NAMES if not hasattr(mod, n)]
        if missing:
            raise ImportError(f"system file {path} lacks "
                              f"{', '.join(missing)}")
        return mod

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a cell reports: end-to-end ones with
        ``trace`` off, per-layer ones with it on; an entry with a
        ``workloads`` key only in the cells it lists."""
        entries = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in entries
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        return _module(self.bench_dir / "metrics" / f"{metric}.py",
                       f"gpubench_metric_{_safe(metric)}")
