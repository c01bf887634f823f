"""What a run loads, what it refuses to run without, and what the benchmark
reads: no JAX, no JAX package, nothing of the JAX harness."""
from __future__ import annotations

import ast
import json
import pathlib
import shutil
import subprocess
import sys

from gpubench.tests.tinyroot import BENCH, REPO, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _python(code: str, cwd: pathlib.Path) -> subprocess.CompletedProcess:
    env = {"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           "HOME": str(cwd), "TMPDIR": str(cwd)}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    root = make_root(tmp_path)
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gpubench import run\n"
        "rc = run.main(['--workload', 'tiny-stacked-b4', '--seed', '5',"
        " '--seconds', '0.3', '--trace', '1'], device='cpu')\n"
        "print(json.dumps({'rc': rc, 'top': sorted({m.split('.')[0]"
        " for m in sys.modules})}))\n")
    p = _python(code, root)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    result, loaded = json.loads(lines[-2]), json.loads(lines[-1])
    assert loaded["rc"] == 0 and result["correct"] is True
    assert "repro_torch" in loaded["top"]
    assert not FORBIDDEN & set(loaded["top"])
    assert list(result)[-1] == "checks"  # the compared numbers come last
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


LOADS_REPRO = '''"""A metric reader that loads a module named ``repro``."""
import importlib
import pathlib
import sys


def read(rec):
    sys.path.insert(0, str(pathlib.Path(__file__).parents[2] / "stub"))
    importlib.import_module("repro")
    return 1.0
'''


def test_a_reader_that_loads_the_jax_package_gets_no_result(tmp_path):
    root = make_root(tmp_path / "root", {"tiny_loads_repro": LOADS_REPRO})
    (root / "stub" / "repro").mkdir(parents=True)
    (root / "stub" / "repro" / "__init__.py").write_text("")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gpubench import run\n"
        "sys.exit(run.main(['--workload', 'tiny-b2', '--seed', '6',"
        " '--seconds', '0.2', '--trace', '1'], device='cpu'))\n")
    p = _python(code, root)
    assert p.returncode != 0
    assert p.stdout.strip() == ""  # no result line, nothing else either
    assert "forbidden modules loaded: repro" in p.stderr


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import gpubench.reference.decoder, gpubench.reference.sets\n"
        "import gpubench.reference.search, gpubench.reference.judge\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = _python(code, tmp_path)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "gpubench" in top
    assert not (FORBIDDEN | {"repro_torch"}) & top


def test_no_source_imports_jax_the_jax_package_or_its_harness():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN | {"benchmarks"}, (path, n)
        if "tests" not in path.parts:  # this file names what it looks for
            assert "benchmarks/" not in path.read_text(), path


def test_refuses_without_cards_or_without_the_port(tmp_path):
    # no CUDA here: non-zero, nothing on stdout
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "gr3b-single-b2", "--seed", "1", "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    # only BENCHMARK.json and the benchmark's files: non-zero, nothing
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "gr3b-single-b2", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
