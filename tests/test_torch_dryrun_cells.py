"""The port's dry-run cells (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``) on both production meshes.

The reference builds its cells on a ``jax.sharding.AbstractMesh`` of
(16, 16) and (2, 16, 16), which needs no devices; the port on a ``MeshSpec``
of the same shape.  For every runnable cell: the kind, notes and donated
arguments, every argument leaf's shape and dtype, every argument and output
spec, and the analytic model FLOPs.  A stacked layer leaf of the reference
(``dense_layers``, ``moe_layers``, ``processor``) is the port's list of
per-layer leaves, each with the reference's shape and spec minus the
leading layer axis.  A decode cache's ``pos`` is a scalar array in the
reference and a Python int in the port (its spec is ``()`` in both).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch import steps as jsteps
from repro_torch.configs import get_bundle
from repro_torch.launch import steps
from repro_torch.launch.mesh import production_spec
from repro_torch.models.kvcache import KVCache, MLACache

MESHES = {
    "16x16": ((16, 16), ("data", "model"), False),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True),
}
_STACKED = {"dense_layers": "layers", "moe_layers": "layers",
            "processor": "processor"}
_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.uint8): torch.uint8,
           jnp.dtype(jnp.bool_): torch.bool}


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _is_spec_leaf(x):
    return isinstance(x, jax.sharding.NamedSharding)


def _ref_flat(tree, layers):
    """``{path: (leaf, stacked)}`` of a reference tree under the port's
    paths: a stacked leaf becomes one entry per layer (``layers`` maps each
    stacked group to the port's layer indices)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=_is_spec_leaf)[0]:
        keys = [_key(k) for k in path]
        stacked = [i for i, k in enumerate(keys) if k in _STACKED]
        if not stacked:
            out[tuple(keys)] = (leaf, False)
            continue
        j = stacked[0]
        span = layers[keys[j]]
        if hasattr(leaf, "shape"):
            assert leaf.shape[0] == len(span), (keys, leaf.shape, span)
        for i in span:
            out[tuple(keys[:j]) + (_STACKED[keys[j]], i)
                + tuple(keys[j + 1:])] = (leaf, True)
    return out


def _layers(cfg):
    n = getattr(cfg, "n_layers", 0)
    moe = getattr(cfg, "moe", None)
    n_dense = moe.first_dense_layers if moe is not None else n
    return {"dense_layers": range(n_dense), "moe_layers": range(n_dense, n),
            "processor": range(n)}


def _port_flat(tree, prefix=()):
    """``{path: leaf}`` of a port argument tree (a cache by field name)."""
    if isinstance(tree, (KVCache, MLACache)):
        return {prefix + (k,): v for k, v in vars(tree).items()
                if isinstance(v, torch.Tensor)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_port_flat(v, prefix + (k,)))
    return out


def _is_port_spec(x):
    """A spec: a tuple of ``None``, axis names and tuples of axis names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _port_spec_flat(tree, prefix=()):
    """Like :func:`_port_flat` over a spec tree (a spec is a tuple)."""
    if _is_port_spec(tree):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_spec_flat(v, prefix + (k,)))
    return out


def _compare(ref_tree, port_flat, what, label, layers):
    """Every reference leaf (per layer for stacked ones) against the
    port's, and no port leaf left over; returns the number checked."""
    ref = _ref_flat(ref_tree, layers)
    n = 0
    for key, (leaf, stacked) in ref.items():
        if key and key[-1] == "pos" and what == "arg":  # the port's is an int
            assert leaf.shape == ()
            continue
        assert key in port_flat, (label, key, sorted(port_flat)[:8])
        got = port_flat[key]
        if what == "spec":
            want = tuple(leaf.spec)
            assert got == (want[1:] if stacked else want), (label, key, got,
                                                            want)
        else:
            want = leaf.shape[1:] if stacked else leaf.shape
            assert tuple(got.shape) == tuple(want), (label, key, got.shape)
            assert got.dtype == _DTYPES[jnp.dtype(leaf.dtype)], (label, key)
            assert got.device.type == "meta", (label, key)
        n += 1
    extra = set(port_flat) - set(ref)
    assert not extra, (label, sorted(extra)[:8])
    return n


@pytest.fixture(scope="module")
def cells():
    """{mesh name: (reference cells, port cells)} for every runnable cell."""
    runnable, _ = steps.list_cells()
    out = {}
    for name, (shape, axes, multi) in MESHES.items():
        amesh = AbstractMesh(shape, axes)
        spec = production_spec(multi_pod=multi)
        out[name] = {
            (a, s): (jsteps.build_cell(a, s, amesh), steps.build_cell(a, s, spec))
            for a, s, _ in runnable}
    return out


def test_list_cells_match_the_reference():
    runnable, skipped = steps.list_cells()
    jrun, jskip = jsteps.list_cells()
    assert runnable == jrun and skipped == jskip
    assert len(runnable) == 40 and len(skipped) == 3
    assert {(a, s) for a, s, _ in skipped} == {
        ("stablelm-12b", "long_500k"), ("qwen1.5-110b", "long_500k"),
        ("codeqwen1.5-7b", "long_500k")}
    for a, s, _ in skipped:
        with pytest.raises(ValueError, match="skipped"):
            steps.build_cell(a, s, production_spec())
    assert steps.list_cells(include_gr=False)[0] == jsteps.list_cells(
        include_gr=False)[0]


RUNNABLE = [(a, s) for a, s, _ in steps.list_cells()[0]]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", RUNNABLE,
                         ids=[f"{a}-{s}" for a, s in RUNNABLE])
def test_cell_matches_the_reference(cells, mesh, arch, shape):
    ref, port = cells[mesh][(arch, shape)]
    label = (mesh, arch, shape)
    assert port.kind == ref.kind, label
    assert port.notes == ref.notes, label
    assert port.donate_argnums == ref.donate_argnums, label
    assert port.arch_id == arch and port.shape_name == shape
    np.testing.assert_allclose(port.model_flops_per_chip,
                               ref.model_flops_per_chip, rtol=1e-12)
    assert len(port.args) == len(ref.args) == len(port.in_specs)
    assert _compare_cell(ref, port, arch, label) > 0


def _compare_cell(ref, port, arch, label, overrides=None):
    cfg = get_bundle(arch).config
    if overrides:
        cfg = dataclasses.replace(cfg, **{
            k: v for k, v in overrides.items() if k != "moe_dispatch_groups"})
    layers = _layers(cfg)
    n = 0
    for i, (ra, pa) in enumerate(zip(ref.args, port.args)):
        n += _compare(ra, _port_flat(pa), "arg", label + ("arg", i), layers)
    for i, (rs, ps) in enumerate(zip(ref.in_shardings, port.in_specs)):
        n += _compare(rs, _port_spec_flat(ps), "spec", label + ("in", i),
                      layers)
    n += _compare(ref.out_shardings, _port_spec_flat(port.out_specs), "spec",
                  label + ("out",), layers)
    return n


def test_input_specs_are_the_cells_args():
    spec = production_spec()
    args = steps.input_specs("static-gr", "gr_serve_constrained", spec)
    cell = steps.build_cell("static-gr", "gr_serve_constrained", spec)
    assert [tuple(a.shape) for a in args[1:8]] == [
        tuple(a.shape) for a in cell.args[1:8]]


@pytest.mark.parametrize("overrides", [
    {"serve_replicate_weights": True},
    {"gr_batched_beams": True},
    {"gr_batched_beams": True, "serve_replicate_weights": True},
], ids=["replicate", "batched", "batched-replicate"])
@pytest.mark.parametrize("kind", ["gr_serve_constrained",
                                  "gr_serve_unconstrained"])
def test_gr_override_branches_match_the_reference(overrides, kind):
    """The branches only ``cfg_overrides`` reach, on the (16, 16) mesh."""
    shape, axes, _ = MESHES["16x16"]
    ref = jsteps.build_cell("static-gr", kind, AbstractMesh(shape, axes),
                            cfg_overrides=overrides)
    port = steps.build_cell("static-gr", kind, production_spec(),
                            cfg_overrides=overrides)
    assert _compare_cell(ref, port, "static-gr", (kind, overrides)) > 0
    assert port.notes == ref.notes


@pytest.mark.parametrize("arch,shape,overrides", [
    ("deepseek-v2-lite-16b", "decode_32k", {"defer_cache_write": True}),
    ("stablelm-12b", "decode_32k", {"defer_cache_write": True}),
    ("mixtral-8x7b", "train_4k", {"moe_dispatch_groups": 4,
                                  "train_microbatches": 2}),
    ("stablelm-12b", "train_4k", {"use_sp": False}),
])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_override_branches_match_the_reference(arch, shape, overrides, mesh):
    dims, axes, multi = MESHES[mesh]
    ref = jsteps.build_cell(arch, shape, AbstractMesh(dims, axes),
                            cfg_overrides=overrides)
    port = steps.build_cell(arch, shape, production_spec(multi_pod=multi),
                            cfg_overrides=overrides)
    assert port.notes == ref.notes
    np.testing.assert_allclose(port.model_flops_per_chip,
                               ref.model_flops_per_chip, rtol=1e-12)
    assert _compare_cell(ref, port, arch, (mesh, arch, shape),
                         overrides) > 0


def test_split_k_decode_states_why_the_cache_is_placed_by_its_spec():
    cell = steps.build_cell("stablelm-12b", "decode_32k", production_spec(),
                            cfg_overrides={"decode_split_k": True})
    assert "decode_split_k" in cell.notes and "sequence-sharded" in cell.notes
