"""Run a series of benchmark runs, each in its own process, one after another.

    python3 gpubench/series.py --out runs.jsonl \\
        --run gr3b-single-b2:101:30:0 --run gr3b-single-b2:102:30:1 ...

Each ``--run`` is ``workload:seed:seconds:trace``.  Every run appends one
JSON line to ``--out``: the run's exit code, wall seconds, its result line
(parsed) and the end of its standard error.  This is how the spreads behind
``BENCHMARK.json``'s bounds are measured: two sets of runs of a cell with the
same seeds, in one call on one card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

RUN = pathlib.Path(__file__).resolve().parent / "run.py"


def run_one(workload: str, seed: int, seconds: float, trace: int,
            timeout: float) -> dict:
    cmd = [sys.executable, str(RUN), "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "seconds": seconds,
            "trace": trace, "rc": rc, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr_tail": err[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", required=True,
                    help="workload:seed:seconds:trace")
    ap.add_argument("--timeout", type=float, default=1300.0)
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    worst = 0
    for spec in args.run:
        w, seed, secs, trace = spec.split(":")
        rec = run_one(w, int(seed), float(secs), int(trace), args.timeout)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        res = rec["result"] or {}
        print(json.dumps({k: rec[k] for k in ("workload", "seed", "trace",
                                              "rc", "wall_s")}
                         | {"correct": res.get("correct"),
                            "metrics": {k: v["value"] for k, v in
                                        res.get("metrics", {}).items()},
                            "checks": {k: v["value"] for k, v in
                                       res.get("checks", {}).items()}}),
              flush=True)
        worst = max(worst, rec["rc"])
    return worst


if __name__ == "__main__":
    sys.exit(main())
