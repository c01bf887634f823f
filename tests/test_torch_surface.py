"""Completeness guard of the port against the JAX package.

For every module under ``src/repro/``: each public top-level name (and each
name a package ``__init__`` exports) exists at the same place under
``src/repro_torch/``, or stands in :data:`SUBSTITUTES` with its counterpart
and the reason it differs.  Every ``examples/X.py`` has an
``examples/X_torch.py``.  Pure ``ast`` over both trees: imports neither JAX
nor the port.
"""
import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ROOT / "examples"

_PALLAS = "the hand-written CUDA kernel in place of the Pallas TPU kernel"
_FUSED = "the same CUDA kernel with fused=True"
_ORACLE = "the plain PyTorch version the kernels are held against"
_XLA = "the port's plain reference in place of the XLA formulation"

# (module under src/repro/, name): ("module:name" under src/repro_torch/, or
# None where no counterpart applies, and why)
SUBSTITUTES = {
    ("core/__init__.py", "vntk_xla"):
        ("core/vntk.py:vntk_reference_scatter", _XLA),
    ("core/vntk.py", "vntk_xla"):
        ("core/vntk.py:vntk_reference_scatter", _XLA),
    ("core/vntk.py", "vntk_stacked_xla"):
        ("core/vntk.py:vntk_stacked_reference_scatter", _XLA),
    ("core/vntk.py", "vntk_topk_xla"):
        ("core/vntk.py:vntk_topk_reference", _XLA),
    ("core/vntk.py", "vntk_stacked_topk_xla"):
        ("core/vntk.py:vntk_stacked_topk_reference", _XLA),
    ("core/vntk.py", "LANE_PALLAS"):
        ("core/vntk.py:LANE", "one candidate lane: the CUDA kernels have no "
                              "128-wide VMEM tile to round to"),
    ("core/vntk.py", "LANE_XLA"):
        ("core/vntk.py:LANE", "the reference's XLA lane, the port's only one"),
    ("core/types.py", "Impl"):
        ("decoding/__init__.py:Impl", "derived from kernels.ops.IMPLS: None "
                                      "or 'plain', not 'xla'/'pallas'"),
    ("kernels/vntk.py", "vntk_pallas"): ("kernels/vntk.py:vntk_mask_cuda",
                                         _PALLAS),
    ("kernels/vntk.py", "vntk_fused_logsoftmax_pallas"):
        ("kernels/vntk.py:vntk_mask_cuda", _FUSED),
    ("kernels/vntk.py", "vntk_stacked_pallas"):
        ("kernels/vntk.py:vntk_stacked_mask_cuda", _PALLAS),
    ("kernels/vntk.py", "vntk_stacked_fused_logsoftmax_pallas"):
        ("kernels/vntk.py:vntk_stacked_mask_cuda", _FUSED),
    ("kernels/vntk.py", "vntk_topk_pallas"):
        ("kernels/vntk.py:vntk_topk_cuda", _PALLAS),
    ("kernels/vntk.py", "vntk_stacked_topk_pallas"):
        ("kernels/vntk.py:vntk_stacked_topk_cuda", _PALLAS),
    ("kernels/vntk.py", "vntk_compressed_pallas"):
        ("kernels/vntk.py:vntk_compressed_mask_cuda", _PALLAS),
    ("kernels/vntk.py", "vntk_stacked_compressed_pallas"):
        ("kernels/vntk.py:vntk_stacked_compressed_mask_cuda", _PALLAS),
    ("kernels/vntk.py", "vntk_compressed_topk_pallas"):
        ("kernels/vntk.py:vntk_compressed_topk_cuda", _PALLAS),
    ("kernels/vntk.py", "vntk_stacked_compressed_topk_pallas"):
        ("kernels/vntk.py:vntk_stacked_compressed_topk_cuda", _PALLAS),
    ("kernels/embedding_bag.py", "embedding_bag_pallas"):
        ("kernels/embedding_bag.py:embedding_bag_cuda", _PALLAS),
    ("kernels/ref.py", "vntk_ref"): ("kernels/vntk.py:vntk_mask_plain",
                                     _ORACLE),
    ("kernels/ref.py", "vntk_fused_logsoftmax_ref"):
        ("kernels/vntk.py:vntk_mask_plain", _ORACLE),
    ("kernels/ref.py", "vntk_stacked_ref"):
        ("kernels/vntk.py:vntk_stacked_mask_plain", _ORACLE),
    ("kernels/ref.py", "vntk_stacked_fused_logsoftmax_ref"):
        ("kernels/vntk.py:vntk_stacked_mask_plain", _ORACLE),
    ("kernels/ref.py", "vntk_topk_ref"): ("kernels/vntk.py:vntk_topk_plain",
                                          _ORACLE),
    ("kernels/ref.py", "vntk_stacked_topk_ref"):
        ("kernels/vntk.py:vntk_stacked_topk_plain", _ORACLE),
    ("kernels/ref.py", "vntk_compressed_ref"):
        ("kernels/vntk.py:vntk_compressed_mask_plain", _ORACLE),
    ("kernels/ref.py", "vntk_stacked_compressed_ref"):
        ("kernels/vntk.py:vntk_stacked_compressed_mask_plain", _ORACLE),
    ("kernels/ref.py", "vntk_compressed_topk_ref"):
        ("kernels/vntk.py:vntk_compressed_topk_plain", _ORACLE),
    ("kernels/ref.py", "vntk_stacked_compressed_topk_ref"):
        ("kernels/vntk.py:vntk_stacked_compressed_topk_plain", _ORACLE),
    ("kernels/ref.py", "embedding_bag_ref"):
        ("kernels/embedding_bag.py:embedding_bag_plain", _ORACLE),
    ("models/recsys.py", "embedding_bag"):
        ("kernels/ops.py:embedding_bag", "the model's bags go through the "
                                         "kernel dispatcher"),
    ("distributed/collectives.py", "parse_collective_bytes"):
        ("distributed/collectives.py:CollectiveLog",
         "collectives counted where they are issued; there is no HLO text"),
    ("distributed/sharding.py", "ns"):
        ("distributed/sharding.py:shard_tensor",
         "a spec placed on a DeviceMesh; no NamedSharding object"),
    ("distributed/sharding.py", "replicated"):
        ("distributed/sharding.py:placements",
         "the spec () maps to Replicate placements"),
    ("distributed/sharding.py", "tree_shardings"):
        ("distributed/sharding.py:shard_tensor",
         "specs are placed tensor by tensor"),
    ("distributed/sharding.py", "shard_map_compat"):
        (None, "a JAX-version shim of shard_map; the port runs a process "
               "per rank under torch.distributed"),
    ("launch/mesh.py", "make_mesh_compat"):
        ("launch/mesh.py:make_subset_mesh",
         "a DeviceMesh over the world's ranks; no JAX-version shim"),
    ("launch/mesh.py", "set_mesh_compat"):
        (None, "a JAX-version shim of the ambient mesh; torch has none, "
               "every call takes its DeviceMesh"),
}


def _bound(body, with_imports: bool) -> set:
    """Names a module body binds at top level (through ``if``/``try``)."""
    names = set()
    for n in body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            names |= {e.id for t in targets for e in ast.walk(t)
                      if isinstance(e, ast.Name)}
        elif with_imports and isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in n.names}
        elif isinstance(n, ast.If):
            names |= _bound(n.body + n.orelse, with_imports)
        elif isinstance(n, ast.Try):
            names |= _bound(n.body + n.orelse + n.finalbody, with_imports)
    return names


@functools.cache
def _names(path: pathlib.Path, with_imports: bool) -> frozenset:
    if not path.exists():
        return frozenset()
    return frozenset(_bound(ast.parse(path.read_text()).body, with_imports))


def reference_public(rel: str) -> set:
    """Public top-level names of ``src/repro/<rel>``; a package ``__init__``
    also exports what it imports."""
    path = REF / rel
    return {n for n in _names(path, path.name == "__init__.py")
            if not n.startswith("_")}


def port_names(rel: str) -> set:
    return _names(PORT / rel, with_imports=True)


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_the_walk_sees_both_trees():
    assert len(MODULES) > 80
    assert "beam_search" in reference_public("core/__init__.py")
    assert "vntk_topk_pallas" in reference_public("kernels/vntk.py")
    assert "jax" not in reference_public("core/vntk.py")  # imports: not API


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    missing = {n for n in reference_public(rel) - port_names(rel)
               if (rel, n) not in SUBSTITUTES}
    assert not missing, (
        f"src/repro/{rel}: {sorted(missing)} have no counterpart in "
        f"src/repro_torch/{rel} and no SUBSTITUTES entry")


@pytest.mark.parametrize("key", sorted(SUBSTITUTES), ids="{0[0]}:{0[1]}".format)
def test_every_substitute_is_needed_and_exists(key):
    rel, name = key
    counterpart, reason = SUBSTITUTES[key]
    assert name in reference_public(rel), "the reference has no such name"
    assert name not in port_names(rel), "the port has it: drop the entry"
    assert reason
    if counterpart is not None:
        module, target = counterpart.split(":")
        assert target in port_names(module), counterpart


def test_every_example_has_a_torch_twin():
    scripts = sorted(p.stem for p in EXAMPLES.glob("*.py")
                     if not p.stem.endswith("_torch"))
    assert len(scripts) == 5
    missing = [s for s in scripts
               if not (EXAMPLES / f"{s}_torch.py").exists()]
    assert not missing
