"""One run of one cell: set-up, the measured window, the traced rounds, the
comparison, and the result line's fields.

How the window issues requests is the traffic's ``loop``, a file of its own
(``gpubench/loops/<loop>.py``, see :class:`Window`).  Set-up runs from the
process's start to the window's beginning and includes the loop's warm-up
rounds (the traffic's ``warmup_rounds``), so every shape the window uses has
run before it.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from gpubench.harness import data
from gpubench.harness.trace import Trace
from gpubench.harness.traffic import make_requests

__all__ = ["Record", "Window", "run_cell", "make_inputs", "sample_requests"]


@dataclasses.dataclass
class Window:
    """What a loop's ``window(system, reqs, served, *, seconds=None,
    rounds=None)`` returns: it serves requests of ``reqs`` through
    ``system.serve`` until ``seconds`` have passed, or for ``rounds``
    ``serve()`` calls, and appends each answered request to ``served``."""
    start: float  # time.perf_counter() as the window began
    seconds: float = 0.0  # from ``start`` to the last answer
    calls: int = 0  # serve() calls, one retrieve of a full batch each
    attempted: int = 0
    failed: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    serve_s: float = 0.0  # host clock inside serve() calls


@dataclasses.dataclass
class Record:
    """What metric readers read (``gpubench/metrics/<name>.py``)."""
    cfg: dict
    traffic: dict
    setup_s: float
    window_s: float = 0.0
    rounds: int = 0  # serve() calls (one retrieve each) in the window
    requests: int = 0  # requests answered in the window
    latencies_s: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    launches: int = 0  # constraint-kernel launches in the window
    index_bytes: int = 0
    passes: list = dataclasses.field(default_factory=list)  # work a retrieve
    trace: Optional[Trace] = None  # device activity alone
    host_trace: Optional[Trace] = None  # host ops too (spans, gap labels)
    trace_rounds: int = 0  # serve() calls in each of the two traces
    trace_serve_s: float = 0.0  # host clock around serve(), host trace
    phases: dict = dataclasses.field(default_factory=dict)  # seconds a part


def sample_requests(served: list, n: int, seed: int) -> list:
    """At most ``n`` answered requests drawn from the seed: one at each
    position of the batch (preferring a constraint id not drawn yet), then
    one of each id still missing, then any, while fewer than ``n``."""
    rng = np.random.default_rng(data.stream_seed(seed, "sample"))
    order = [int(i) for i in rng.permutation(len(served))]
    picked, ids = [], set()

    def take(i):
        picked.append(i)
        ids.add(served[i]["cid"])

    for pos in sorted({r["pos"] for r in served}):
        at = [i for i in order if served[i]["pos"] == pos]
        fresh = [i for i in at if served[i]["cid"] not in ids]
        take((fresh or at)[0])
    for i in order:
        if served[i]["cid"] not in ids:
            take(i)
    picked += [i for i in order if i not in picked][:max(n - len(picked), 0)]
    return [served[i] for i in picked[:n]]


def make_inputs(sysmod, cfg: dict, traffic: dict, seed: int, device,
                phase=lambda name: None) -> tuple:
    """The cell's inputs from the seed: (weights, catalog SIDs, catalog
    metadata, the request pool); the weights are the system file
    ``sysmod``'s; ``phase(name)`` marks each part's end."""
    s, ix = cfg["search"], cfg["index"]
    weights = sysmod.make_weights(cfg["model"], seed, device)
    phase("weights")
    catalog = data.make_catalog(ix["n_items"], s["sid_length"], s["sid_vocab"],
                                seed, device)
    meta = (data.make_meta(catalog.shape[0], seed, device,
                           ix["max_age_days"], ix["n_categories"])
            if ix["kind"] == "stacked" else {})
    reqs = make_requests(traffic, catalog, len(ix.get("slots", [])), seed)
    phase("catalog_and_requests")
    return weights, catalog, meta, reqs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(spec, cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, marks=()) -> tuple:
    """(Record, correctness dict, attempted, failed) of one run.  ``t_start``
    is the process's start on ``time.perf_counter``'s clock; ``marks``, the
    (name, time) ends of set-up's parts before this call."""
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    loop = spec.loop(traffic["loop"])
    s = cfg["search"]

    phases, clock = {}, [t_start]
    for name, t in marks:
        phases[name], clock[0] = t - clock[0], t

    def phase(name):
        _sync(device)
        now = time.perf_counter()
        phases[name] = now - clock[0]
        clock[0] = now

    sysmod = spec.system(cfg["system"])
    phase("port_imports")
    weights, catalog, meta, reqs = make_inputs(sysmod, cfg, traffic, seed,
                                               device, phase)
    system = sysmod.System(cfg, traffic, weights, catalog, meta, device)
    phase("program_index_and_engine")
    loop.window(system, reqs, [], rounds=traffic["warmup_rounds"])
    phase("warmup")

    served: list = []
    launches0 = system.launches()
    w = loop.window(system, reqs, served, seconds=seconds)
    rec = Record(cfg=cfg, traffic=traffic, setup_s=w.start - t_start,
                 phases=phases, window_s=w.seconds, rounds=w.calls,
                 requests=w.attempted - w.failed, latencies_s=w.latencies_s)
    attempted, failed = w.attempted, w.failed
    rec.launches = system.launches() - launches0
    rec.peak_bytes = (int(torch.cuda.max_memory_allocated(device))
                      if device.type == "cuda" else 0)
    rec.index_bytes = system.index_bytes()
    rec.passes = sysmod.retrieve_passes(cfg["model"], traffic["batch"],
                                        s["beam_size"], s["max_len"] // 2,
                                        s["sid_length"])
    if trace:
        rec.trace_rounds = traffic["trace_rounds"]
        for host in (False, True):
            with Trace(device, host=host) as tr:
                tw = loop.window(system, reqs, served,
                                 rounds=rec.trace_rounds)
            attempted += tw.attempted
            failed += tw.failed
            if host:
                rec.host_trace, rec.trace_serve_s = tr, tw.serve_s
            else:
                rec.trace = tr

    clock[0] = time.perf_counter()
    system.close()
    del system
    gc.collect()
    sample = sample_requests(served, traffic["check_requests"], seed)
    readings = sysmod.judge(cfg, weights, catalog, meta, served, sample)
    phase("check")
    return rec, readings, attempted, failed
