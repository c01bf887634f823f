"""Logical-axis sharding rules for every architecture family
(``repro.distributed.sharding``).

Mesh axes:
  * ``pod``   — outer data parallelism across pods (multi-pod mesh only)
  * ``data``  — intra-pod data parallelism
  * ``model`` — tensor/expert/sequence parallelism (intra-pod)

A spec is the port's ``PartitionSpec``: a tuple with one entry per tensor
dim, each an axis name, a tuple of axis names, or ``None`` (``()``
replicates), equal to ``tuple(P)`` of the reference's spec.  The rule
functions take a ``DeviceMesh`` or a :class:`~repro_torch.launch.mesh
.MeshSpec` and return a tree of specs shaped like their input: the port's
parameter dicts (the keys of :mod:`repro_torch.convert`), whose per-layer
``layers`` list holds one dict per layer.  The reference stacks the layers
on a leading axis, so its spec for a layer leaf is the port's with a
leading ``None``.  The rules are those of the reference:

LM (Megatron-style TP with GQA-aware KV handling): embeddings vocab-sharded;
attention Q projections column-parallel on the flattened (H*Dh) dim; K/V
projections column-parallel only when the kv heads divide the model axis,
else row-parallel on d_model; output and FFN-down row-parallel; FFN-up/gate
column-parallel.  MoE experts expert-parallel when n_experts divides the
model axis, otherwise per-expert tensor-parallel.  Decode caches are
sequence-sharded over ``model``.  Recsys tables are vocab-sharded over
``model`` when they have at least 4 rows per rank, replicated otherwise.
GNN parameters replicate; node/edge arrays shard over every axis.

:func:`placements` maps a spec onto a ``DeviceMesh`` as
``torch.distributed.tensor`` placements and :func:`shard_tensor` places a
tensor by it.  The reference's ``shard_map_compat``, ``ns``, ``replicated``
and ``tree_shardings`` build JAX sharding objects and have no torch
counterpart.
"""
from __future__ import annotations

import torch

__all__ = [
    "dp_axes", "dp_size", "dp_rank", "model_size", "axis_size",
    "lm_param_pspecs", "lm_batch_pspec", "kv_cache_pspecs",
    "recsys_param_pspecs", "recsys_batch_pspec", "gnn_param_pspecs",
    "graph_axes", "placements", "shard_tensor",
]


def axis_size(mesh, name: str) -> int:
    return mesh.shape[list(mesh.mesh_dim_names).index(name)]


def dp_axes(mesh) -> tuple:
    """Axes used for batch (data) parallelism."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_size(mesh) -> int:
    """Total data-parallel ways: product of the mesh's dp axis sizes."""
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def dp_rank(mesh) -> int:
    """This rank's index along the flattened dp axes (``pod`` major): the
    block of the batch it holds under ``P(dp_axes)``."""
    r = 0
    for a in dp_axes(mesh):
        r = r * axis_size(mesh, a) + mesh.get_local_rank(a)
    return r


def model_size(mesh) -> int:
    return axis_size(mesh, "model")


def _entry(axes: tuple):
    """A spec entry over ``axes``, normalized as ``PartitionSpec`` does:
    none is ``None``, one is its name."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _map_with_path(fn, tree, path=()):
    """``fn("/".join(dict keys), leaf)`` over nested dicts and lists (list
    positions are not part of the path, as the reference's stacked layers
    have none)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path) for v in tree]
    return fn("/".join(path), tree)


# --------------------------------------------------------------------------
# LM family
# --------------------------------------------------------------------------


def _lm_leaf_pspec(path: str, shape, ms: int, n_kv_heads: int = 0) -> tuple:
    """The reference's ``_lm_leaf_pspec`` on the port's per-layer shapes
    (one dim fewer than the reference's stacked ones on layer leaves)."""
    rank = len(shape)

    def div(d):
        return shape[d] % ms == 0

    if "emb" in path and "unemb" not in path:
        return ("model", None) if div(0) else ()
    if "unemb" in path:
        return (None, "model") if div(1) else ()
    if any(k in path for k in ("wq", "w_kv_b")):
        # column-parallel: shard the flattened head-output dim (last)
        if rank == 2 and div(1):
            return (None, "model")
        if rank == 1 and div(0):  # bias (F,)
            return ("model",)
        return ()
    if any(k in path for k in ("wk", "wv")):
        # column-parallel only when kv heads divide TP cleanly; otherwise
        # row-parallel on d_model (partial sums all-reduced)
        if n_kv_heads % ms == 0 and rank == 2 and div(1):
            return (None, "model")
        if rank == 2 and div(0):
            return ("model", None)
        return ()
    if "w_kv_a" in path:  # MLA down-projection: row-parallel on d_model
        return ("model", None) if rank == 2 and div(0) else ()
    if "kv_norm" in path:
        return ()
    if "wo" in path:
        return ("model", None) if rank == 2 and div(0) else ()
    if any(k in path for k in ("ffn", "shared")):
        if "w2" in path:
            return ("model", None) if rank == 2 and div(0) else ()
        return (None, "model") if rank == 2 and div(1) else ()
    if "router" in path:
        return ()
    if "moe" in path and rank == 3:  # (E, D, F) expert weights
        if div(0):
            return ("model", None, None)  # expert-parallel
        # per-expert tensor-parallel
        if "w2" in path:
            return (None, "model", None) if div(1) else ()
        return (None, None, "model") if div(2) else ()
    return ()  # norms, scalars


def lm_param_pspecs(params, mesh, n_kv_heads: int = 0):
    """Parameter dict (tensors, meta tensors, anything with ``.shape``) ->
    spec dict of the same structure."""
    ms = model_size(mesh)
    return _map_with_path(
        lambda p, leaf: _lm_leaf_pspec(p, tuple(leaf.shape), ms, n_kv_heads),
        params)


def lm_batch_pspec(mesh) -> tuple:
    return (_entry(dp_axes(mesh)), None)


def kv_cache_pspecs(cache, mesh, batch_shardable: bool = True) -> dict:
    """Sequence-shard decode caches over ``model``; batch over dp axes.

    ``cache`` is a :class:`~repro_torch.models.kvcache.KVCache` or
    ``MLACache``; the result maps each of its fields but ``ring`` to a
    spec."""
    dp = _entry(dp_axes(mesh)) if batch_shardable else None
    ms = model_size(mesh)
    out = {}
    for name in ("k", "v", "c_kv", "k_rope", "slot_pos", "pos"):
        if not hasattr(cache, name):
            continue
        leaf = getattr(cache, name)
        if name in ("k", "v", "c_kv", "k_rope"):
            # (L, B, slots, ...): slots over model if divisible
            spec = [None, dp, None] + [None] * (leaf.dim() - 3)
            if leaf.shape[2] % ms == 0:
                spec[2] = "model"
            out[name] = tuple(spec)
        else:
            out[name] = ()
    return out


# --------------------------------------------------------------------------
# Recsys
# --------------------------------------------------------------------------


def recsys_param_pspecs(params, mesh):
    ms = model_size(mesh)

    def assign(path, leaf):
        if (("table_" in path or "wide_" in path) and len(leaf.shape) == 2
                and leaf.shape[0] >= 4 * ms):
            return ("model", None)
        return ()

    return _map_with_path(assign, params)


def recsys_batch_pspec(mesh, rank: int) -> tuple:
    return (_entry(dp_axes(mesh)),) + (None,) * (rank - 1)


# --------------------------------------------------------------------------
# GNN
# --------------------------------------------------------------------------


def gnn_param_pspecs(params, mesh):
    del mesh
    return _map_with_path(lambda p, leaf: (), params)  # tiny: replicate


def graph_axes(mesh) -> tuple:
    """Flattened axis tuple for sharding node/edge arrays."""
    return tuple(a for a in ("pod", "data", "model")
                 if a in mesh.mesh_dim_names)


# --------------------------------------------------------------------------
# Placement on a DeviceMesh
# --------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> tuple:
    """One ``Shard(dim)``/``Replicate()`` per mesh dim: mesh dim ``a``
    shards tensor dim ``i`` when ``spec[i]`` names ``a`` (alone or in a
    tuple of axes, major first)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec: tuple, mesh):
    """``t`` as a ``DTensor`` placed on ``mesh`` by ``spec``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh))
