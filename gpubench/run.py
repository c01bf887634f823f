"""Run one benchmark cell once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``gpubench/`` and
the port under ``src/repro_torch``.  It needs the CUDA cards the cell asks
for; without them, or without the port, it exits non-zero and prints no
result.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
also printed as the last lines of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level names


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (the kernel's
    record of it; the top of this script where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_START


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None, *, device: str | None = None) -> int:
    """Run the cell; ``device="cpu"`` skips the look for cards (tests run
    tiny cells so)."""
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"no port under {ROOT / 'src'}")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.set_num_threads(1)  # the host dispatches; no op here wants a pool
    from gpubench.harness.result import result_line
    from gpubench.harness.runner import run_cell
    from gpubench.harness.spec import Spec

    marks = [("interpreter_and_torch", time.perf_counter())]
    spec = Spec(ROOT, BENCH_DIR)
    cell = spec.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            return fail("CUDA is not available")
        if torch.cuda.device_count() < cell["chips"]:
            return fail(f"{cell['chips']} cards asked for, "
                        f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        marks.append(("cuda_init", time.perf_counter()))
    else:
        dev = torch.device(device)
    rec, readings, attempted, failed = run_cell(
        spec, args.workload, args.seed, args.seconds, bool(args.trace), dev,
        process_start(), marks)
    line, check_lines = result_line(spec, cell, rec, readings, attempted,
                                    failed, bool(args.trace), dev)
    # last, once every metric reader has loaded: nothing after this runs
    bad = forbidden_modules()
    if bad:
        return fail(f"forbidden modules loaded: {', '.join(bad)}")
    for text in check_lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
