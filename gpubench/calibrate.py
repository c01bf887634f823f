"""Readings of the control, for setting a configuration's check limits.

    python3 gpubench/calibrate.py --workload <name> --seeds 1,2,3 [--device cpu]

For each seed it makes the cell's inputs as a run does, draws the requests
a run's check would judge (``check_requests`` from the traffic's pool, one
of each constraint id first), and puts the control in the program's place:
the system file's reference decoder computed in fp8 (one precision below
the configuration's bfloat16) searches each request's set with its own
scores.
Those answers are judged as a run judges the program's; one JSON line a seed
gives the readings.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def control_readings(spec, cell_name: str, seed: int, device) -> dict:
    """The control's readings on ``seed``'s inputs of the cell."""
    from gpubench.harness.runner import make_inputs, sample_requests
    from gpubench.reference.judge import control_outputs
    from gpubench.reference.sets import Catalog

    cell = spec.cell(cell_name)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    s, ix = cfg["search"], cfg["index"]
    sysmod = spec.system(cfg["system"])
    weights, catalog, meta, reqs = make_inputs(sysmod, cfg, traffic, seed,
                                               device)
    pool = [{"history": reqs.histories[i], "cid": reqs.cid(i),
             "pos": i % reqs.batch} for i in range(reqs.histories.shape[0])]
    sample = sample_requests(pool, traffic["check_requests"], seed)
    cat = Catalog(catalog, s["sid_vocab"], meta, ix.get("slots"))
    fp8 = sysmod.decoder(weights, cfg["model"], "fp8")
    served = control_outputs(fp8, cat, sample, s["beam_size"],
                             s["sid_length"], s["sid_vocab"])
    del fp8
    gc.collect()
    return sysmod.judge(cfg, weights, catalog, meta, served, served)


def main(argv=None, *, root=ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(root))
    import torch

    from gpubench.harness.spec import Spec

    spec = Spec(root, BENCH_DIR)
    device = torch.device(args.device)
    for seed in (int(x) for x in args.seeds.split(",")):
        readings = control_readings(spec, args.workload, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "fp8", **readings}), flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
