"""One launch surface for every registered scenario (DESIGN.md §12;
``repro.launch.run_scenario``).

    PYTHONPATH=src python -m repro_torch.launch.run_scenario --list
    PYTHONPATH=src python -m repro_torch.launch.run_scenario \
        --scenario cold_start_amazon --smoke --json build/coldstart.json
    PYTHONPATH=src python -m repro_torch.launch.run_scenario \
        --scenario refresh_churn --smoke --set serve.refresh_cycles=4 \
        --device cpu

The scenario name picks the pipeline, ``--smoke`` shrinks it to CI size,
repeatable ``--set key=value`` overrides any config field by dotted path,
and ``--device`` names where it runs (the card unless given).  ``--json``
writes the machine-readable artifact (config + result + gates).  Exit
status is non-zero when a scenario's own gates fail.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

from repro_torch.scenarios import (
    config_to_dict,
    get_default_registry,
    parse_override,
)

logger = logging.getLogger("repro_torch.launch.run_scenario")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="resolve + run a registered scenario")
    ap.add_argument("--scenario", default=None,
                    help="scenario name (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--smoke", action="store_true",
                    help="apply the scenario's smoke shrink (CI size)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="dotted-path config override, repeatable "
                         "(e.g. --set data.cold_frac=0.05)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the scenario seed")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the {config, result, gates} artifact here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--log-level", default="INFO",
                    choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=getattr(logging, args.log_level),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    registry = get_default_registry()
    if args.list:
        for name, desc in registry.describe().items():
            print(f"{name:20s} {desc}")
        return 0
    if args.scenario is None:
        ap.error("--scenario NAME required (or --list)")

    overrides = dict(parse_override(s) for s in args.overrides)
    run = registry.resolve(args.scenario, smoke=args.smoke,
                           overrides=overrides, seed=args.seed,
                           device=args.device)
    logger.info("scenario %s (smoke=%s, seed=%d, device=%s)", args.scenario,
                args.smoke, run.config.seed, run.device)
    ctx = run.run(log=logger.info)
    result = ctx["result"]
    gates = result.get("gates", {})
    logger.info("result: %s", json.dumps(
        {k: v for k, v in result.items() if not isinstance(v, dict)},
        default=str))

    if args.json:
        artifact = {
            "meta": {"scenario": args.scenario, "smoke": args.smoke,
                     "seed": run.config.seed, "overrides": overrides,
                     "device": str(run.device)},
            "config": config_to_dict(run.config),
            "result": result,
            "gates": gates,
        }
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=2, default=str)
        logger.info("wrote %s", args.json)

    if gates and not gates.get("passed", True):
        logger.error("scenario gates FAILED: %s", gates)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
