"""The port's sharding rules, mesh shapes and collective accounting against
the reference's (``repro.distributed.sharding``, ``repro.launch.mesh``,
``repro.distributed.collectives``).

The reference side runs its rules over ``param_specs`` (``jax.eval_shape``
of each architecture's ``init_params``) on a ``jax.sharding.AbstractMesh``,
which needs no devices; the port side over the same shapes in the port's
layout (one dict per layer, meta tensors) on a ``MeshSpec`` of the same
shape, at the production meshes ``(16, 16)`` and ``(2, 16, 16)`` and at
``(4, 2)``.  A layer leaf's reference spec is the port's with a leading
``None`` for the stacked layer axis.  The port's real parameter dicts
(``init_params`` of each smoke config) have the layout the comparison
builds.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_bundle as jax_bundle
from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import collectives as jcoll
from repro.distributed import sharding as js
from repro.launch import mesh as jmesh
from repro.models import gnn as jgnn
from repro.models import kvcache as jkv
from repro.models import recsys as jrecsys
from repro.models import transformer as jtransformer
from repro_torch.configs import smoke_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as ts
from repro_torch.launch import mesh as tmesh
from repro_torch.models import gnn, kvcache, recsys, transformer

MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
    "small": ((4, 2), ("data", "model")),
}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), tmesh.MeshSpec(shape, names)


def _meta(shape):
    return torch.empty(tuple(shape), device="meta")


def _port_layout(tree, family):
    """A reference shape tree in the port's layout: meta tensors, stacked
    layer groups unstacked into the ``layers`` / ``processor`` list."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _meta(t.shape)

    def unstack(t, i):
        if isinstance(t, dict):
            return {k: unstack(v, i) for k, v in t.items()}
        return _meta(t.shape[1:])

    if family in ("lm", "gr"):
        out = {k: conv(v) for k, v in tree.items()
               if k not in ("dense_layers", "moe_layers")}
        out["layers"] = []
        for group in ("dense_layers", "moe_layers"):
            if group in tree:
                n = tree[group]["ln_attn"]["scale"].shape[0]
                out["layers"] += [unstack(tree[group], i) for i in range(n)]
        return out
    if family == "gnn":
        out = {k: conv(v) for k, v in tree.items() if k != "processor"}
        n = jax.tree.leaves(tree["processor"])[0].shape[0]
        out["processor"] = [unstack(tree["processor"], i) for i in range(n)]
        return out
    return conv(tree)


def _port_specs_of(tree, family, jmesh_, tmesh_, cfg):
    """(reference spec leaves by path, port spec tree)."""
    if family in ("lm", "gr"):
        want = js.lm_param_pspecs(tree, jmesh_, n_kv_heads=cfg.n_kv_heads)
        got = ts.lm_param_pspecs(_port_layout(tree, family), tmesh_,
                                 n_kv_heads=cfg.n_kv_heads)
    elif family == "recsys":
        want = js.recsys_param_pspecs(tree, jmesh_)
        got = ts.recsys_param_pspecs(_port_layout(tree, family), tmesh_)
    else:
        want = js.gnn_param_pspecs(tree, jmesh_)
        got = ts.gnn_param_pspecs(_port_layout(tree, family), tmesh_)
    return want, got


def _compare(want, got, tree):
    """Every reference leaf against its port leaf, per layer for the
    stacked groups; returns the number of port leaves checked."""
    n_dense = (tree["dense_layers"]["ln_attn"]["scale"].shape[0]
               if "dense_layers" in tree else 0)
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    n_checked = 0
    for path, spec in leaves:
        keys = [p.key for p in path]
        if keys[0] in ("dense_layers", "moe_layers", "processor"):
            layers = got["processor" if keys[0] == "processor" else "layers"]
            span = {"dense_layers": range(n_dense),
                    "moe_layers": range(n_dense, len(layers)),
                    "processor": range(len(layers))}[keys[0]]
            for i in span:
                leaf = layers[i]
                for k in keys[1:]:
                    leaf = leaf[k]
                assert leaf == tuple(spec)[1:], (keys, i, leaf, spec)
                n_checked += 1
        else:
            leaf = got
            for k in keys:
                leaf = leaf[k]
            assert leaf == tuple(spec), (keys, leaf, spec)
            n_checked += 1
    return n_checked


def _port_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _port_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _port_leaves(v)
    else:
        yield tree


def _shape_tree(arch):
    b = jax_bundle(arch)
    if b.family in ("lm", "gr"):
        return jtransformer.param_specs(b.config), b
    if b.family == "recsys":
        return jrecsys.param_specs(b.config), b
    return jgnn.param_specs(b.config), b


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_pspecs_equal_reference(arch, mesh):
    tree, b = _shape_tree(arch)
    jm, tm = _meshes(mesh)
    want, got = _port_specs_of(tree, b.family, jm, tm, b.config)
    n = _compare(want, got, tree)
    assert n == sum(1 for _ in _port_leaves(got))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_port_params_have_the_compared_layout(arch):
    """The layout the comparison builds is the port's own: the smoke
    config's ``init_params`` has the same keys and shapes."""
    b = jax_bundle(arch)
    jcfg = jax_smoke_config(arch)
    cfg = smoke_config(arch)
    if b.family in ("lm", "gr"):
        tree, real = (jtransformer.param_specs(jcfg),
                      transformer.init_params(cfg, device="cpu"))
    elif b.family == "recsys":
        tree, real = (jrecsys.param_specs(jcfg),
                      recsys.init_params(cfg, device="cpu"))
    else:
        tree, real = (jgnn.param_specs(jcfg),
                      gnn.init_params(cfg, device="cpu"))
    layout = _port_layout(tree, b.family)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(real) == shapes(layout)


@pytest.mark.parametrize("batch_shardable", [True, False])
@pytest.mark.parametrize("max_len", [1024, 1000])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_kv_cache_pspecs_equal_reference(mesh, max_len, batch_shardable):
    jm, tm = _meshes(mesh)
    for jcache, cache in (
            (jax.eval_shape(lambda: jkv.init_kv_cache(4, 8, max_len, 2, 16)),
             kvcache.init_kv_cache(4, 8, max_len, 2, 16, device="meta")),
            (jax.eval_shape(lambda: jkv.init_mla_cache(4, 8, max_len, 32, 8)),
             kvcache.init_mla_cache(4, 8, max_len, 32, 8, device="meta"))):
        want = js.kv_cache_pspecs(jcache, jm, batch_shardable)
        got = ts.kv_cache_pspecs(cache, tm, batch_shardable)
        assert got == {f.name: tuple(getattr(want, f.name))
                       for f in dataclasses.fields(want)
                       if f.name != "ring"}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_axes_and_batch_specs_equal_reference(mesh):
    jm, tm = _meshes(mesh)
    assert ts.dp_axes(tm) == js.dp_axes(jm)
    assert ts.dp_size(tm) == js.dp_size(jm)
    assert ts.model_size(tm) == js.model_size(jm)
    assert ts.graph_axes(tm) == js.graph_axes(jm)
    assert ts.lm_batch_pspec(tm) == tuple(js.lm_batch_pspec(jm))
    for rank in (1, 2, 3):
        assert ts.recsys_batch_pspec(tm, rank) == tuple(
            js.recsys_batch_pspec(jm, rank))


def test_production_meshes_keep_the_reference_shapes():
    assert tmesh.POD_SHAPE == jmesh.POD_SHAPE
    assert tmesh.MULTIPOD_SHAPE == jmesh.MULTIPOD_SHAPE
    spec = tmesh.production_spec(multi_pod=True)
    assert spec.shape == (2, 16, 16) and spec.size() == 512
    assert spec.mesh_dim_names == ("pod", "data", "model")
    assert tmesh.production_spec().size(1) == 16
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.MeshSpec((2, 2), ("data",))


def test_placements_map_specs_onto_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    pod = tmesh.MeshSpec((2, 2, 2), ("pod", "data", "model"))
    assert ts.placements(("model", None), pod) == (
        Replicate(), Replicate(), Shard(0))
    assert ts.placements((("pod", "data"), None, "model"), pod) == (
        Shard(0), Shard(0), Shard(2))
    assert ts.placements((), pod) == (Replicate(),) * 3


def test_collective_link_bytes_equal_reference():
    by_op = {"all-reduce": 1000, "all-gather": 300, "all-to-all": 7,
             "reduce-scatter": 11, "collective-permute": 5, "other": 2}
    assert coll.collective_link_bytes(by_op) == \
        jcoll.collective_link_bytes(by_op)


def test_collective_log_summary_has_the_hlo_parse_shape():
    log = coll.CollectiveLog()
    with coll.recording(log) as rec:
        assert rec is log
        coll._record("all-reduce", 4096)
        coll._record("all-gather", 512)
        coll._record("all-reduce", 1024)
    coll._record("all-reduce", 1)  # not recording any more
    got = log.summary()
    want = jcoll.parse_collective_bytes("")
    assert set(got) == set(want)
    assert got["bytes_by_op"] == {"all-reduce": 5120, "all-gather": 512}
    assert got["counts_by_op"] == {"all-reduce": 2, "all-gather": 1}
    assert got["total_bytes"] == 5632
    assert got["link_bytes"] == int(jcoll.collective_link_bytes(
        got["bytes_by_op"]))
    hlo = ("  %ar = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %x)\n"
           "  %ag = s32[4,16]{1,0} all-gather(s32[2,16]{1,0} %y)\n")
    ref = jcoll.parse_collective_bytes(hlo)
    log = coll.CollectiveLog()
    log.add("all-reduce", 8 * 128 * 4)
    log.add("all-gather", 4 * 16 * 4)
    assert log.summary() == ref
    assert np.isclose(ref["link_bytes"], 2 * 4096 + 256)
