"""Move the reference package's parameters (transformer, MeshGraphNet,
recsys, RQ-VAE), tries, stores and §5.2 baseline tables into the port.

The helpers take host arrays, never JAX objects: the caller converts with
``jax.tree.map(np.asarray, params)`` (or ``np.asarray`` per field), so the
two packages compute with the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (GNNConfig, RecsysConfig,
                                      TransformerConfig)
from repro_torch.constraints.store import _LEAF_FIELDS, ConstraintStore
from repro_torch.core.compressed_slab import CompressedSlab
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.decoding.backends import HashBitmapBackend, PPVBackend
from repro_torch.models.transformer import torch_dtype

__all__ = ["params_from_jax", "gnn_params_from_jax", "recsys_params_from_jax",
           "rqvae_params_from_jax",
           "transition_matrix_from_numpy", "store_from_numpy",
           "slab_from_numpy", "ppv_backend_from_numpy",
           "hash_bitmap_backend_from_numpy"]


def _tensor(a, dtype, device) -> torch.Tensor:
    # numpy has no bfloat16 of its own (ml_dtypes' is not a torch dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a).to(device=device, dtype=dtype)


def _unstack(tree, i):
    """Layer ``i`` of a tree whose leaves are stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(params_np, cfg: TransformerConfig, device=None):
    """The reference's transformer parameter pytree (numpy leaves, layers
    stacked on axis 0 under ``dense_layers`` and then ``moe_layers``) as
    the port's parameter dict: one per-layer list, dense layers first.
    Every leaf takes the config's dtype except the MoE router, which is
    float32 in both packages."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def conv(tree, key=None):
        if isinstance(tree, dict):
            return {k: conv(v, k) for k, v in tree.items()}
        return _tensor(tree, torch.float32 if key == "router" else dtype, dev)

    out = {"emb": conv(params_np["emb"]),
           "final_norm": conv(params_np["final_norm"]), "layers": []}
    for group in ("dense_layers", "moe_layers"):
        if group in params_np:
            stacked = params_np[group]
            n = len(np.asarray(params_np[group]["ln_attn"]["scale"]))
            out["layers"] += [conv(_unstack(stacked, i)) for i in range(n)]
    if len(out["layers"]) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(out['layers'])} layers in the "
                         f"tree, the config has {cfg.n_layers}")
    if "unemb" in params_np:
        out["unemb"] = conv(params_np["unemb"])
    return out


def gnn_params_from_jax(params_np, cfg: GNNConfig, device=None):
    """The reference's MeshGraphNet pytree (numpy leaves; the processor's
    layers stacked on axis 0) as the port's dict, whose ``processor`` is a
    list of per-layer dicts; every leaf in the config's dtype."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, dtype, dev)

    out = {k: conv(v) for k, v in params_np.items() if k != "processor"}
    out["processor"] = [conv(_unstack(params_np["processor"], i))
                        for i in range(cfg.n_layers)]
    return out


def recsys_params_from_jax(params_np, cfg: RecsysConfig, device=None):
    """The reference's recsys parameter pytree (numpy leaves) as the port's
    dict: ``table_i``/``wide_i`` tables, the ``deep``/``bot``/``top`` MLPs
    (``l{i}`` -> ``{w, b}``), ``bias``, ``bilinear`` and ``routing_init``,
    each leaf in its own dtype (the tables in the config's)."""
    dev = resolve_device(device)
    if "table_0" not in params_np:
        raise ValueError(f"{cfg.name}: not a recsys parameter tree")

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.dtype.name == "bfloat16":
            return _tensor(a, torch.bfloat16, dev)
        return torch.from_numpy(np.array(a)).to(dev)

    return conv(params_np)


def rqvae_params_from_jax(params_np, device=None):
    """The reference's RQ-VAE parameter pytree (numpy leaves:
    ``encoder``/``decoder`` MLPs ``l{i}`` -> ``{w, b}``, ``codebooks``) as
    the port's float32 dict."""
    dev = resolve_device(device)
    if "codebooks" not in params_np:
        raise ValueError("not an RQ-VAE parameter tree")

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, torch.float32, dev)

    return conv(params_np)


def transition_matrix_from_numpy(tm, device=None) -> TransitionMatrix:
    """A port :class:`TransitionMatrix` from any object with the reference
    matrix's fields (arrays readable by ``np.asarray``)."""
    arrays = {f: np.array(getattr(tm, f)) for f in (
        "row_pointers", "edges", "l0_mask_packed", "l0_states",
        "l1_mask_packed", "l1_states")}
    meta = dict(vocab_size=int(tm.vocab_size), sid_length=int(tm.sid_length),
                dense_d=int(tm.dense_d),
                level_bmax=tuple(int(b) for b in tm.level_bmax),
                n_states=int(tm.n_states), n_edges=int(tm.n_edges),
                n_constraints=int(tm.n_constraints))
    return TransitionMatrix.from_numpy(arrays, meta, device)


def store_from_numpy(store, device=None) -> ConstraintStore:
    """A port :class:`ConstraintStore` from any object with the reference
    store's fields (arrays readable by ``np.asarray``)."""
    arrays = {f: np.array(getattr(store, f)) for f in _LEAF_FIELDS}
    meta = dict(vocab_size=int(store.vocab_size),
                sid_length=int(store.sid_length), dense_d=int(store.dense_d),
                level_bmax=tuple(int(b) for b in store.level_bmax),
                n_states=int(store.n_states), n_edges=int(store.n_edges),
                num_sets=int(store.num_sets))
    return ConstraintStore.from_numpy(arrays, meta, device)


def slab_from_numpy(slab, device=None) -> CompressedSlab:
    """A port :class:`CompressedSlab` from any object with the reference
    slab's fields (arrays readable by ``np.asarray``), dtypes kept."""
    dev = resolve_device(device)
    return CompressedSlab(
        tok_delta=torch.from_numpy(np.array(slab.tok_delta)).to(dev),
        level_base=torch.from_numpy(np.array(slab.level_base)).to(dev),
        vocab_size=int(slab.vocab_size), sid_length=int(slab.sid_length))


def ppv_backend_from_numpy(ppv, device=None) -> PPVBackend:
    """A port :class:`PPVBackend` from the tables of the reference's
    ``PPVBaseline`` or ``PPVBackend``: ``sids_sorted`` as int32 and the
    uint32 ``keys`` held as int64."""
    dev = resolve_device(device)
    return PPVBackend(
        sids_sorted=torch.from_numpy(
            np.asarray(ppv.sids_sorted).astype(np.int32)).to(dev),
        keys=torch.from_numpy(np.asarray(ppv.keys).astype(np.int64)).to(dev),
        n=int(ppv.n), vocab_size=int(ppv.vocab_size),
        sid_length=int(ppv.sid_length), exact=bool(ppv.exact),
        top_k=int(ppv.top_k), n_search_steps=int(ppv.n_search_steps))


def hash_bitmap_backend_from_numpy(bmp, device=None) -> HashBitmapBackend:
    """A port :class:`HashBitmapBackend` from the uint8 ``bitmap`` of the
    reference's ``HashBitmapBaseline`` or ``HashBitmapBackend``."""
    return HashBitmapBackend(
        bitmap=torch.from_numpy(np.array(bmp.bitmap, dtype=np.uint8)).to(
            resolve_device(device)),
        vocab_size=int(bmp.vocab_size), sid_length=int(bmp.sid_length),
        log2_bits=int(bmp.log2_bits))
