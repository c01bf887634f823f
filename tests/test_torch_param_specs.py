"""``param_specs`` of the three model families (``repro_torch.models``):
meta trees that :func:`init_params` lays out, held against ``init_params``
on the CPU and against the reference's ``param_specs`` for every
architecture; and the dry run's other meta stand-ins (``init_cache``,
AdamW's state)."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_bundle as jax_bundle
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCHS, get_bundle, smoke_config
from repro_torch.models import gnn, recsys, transformer
from repro_torch.training.optimizer import adamw
from repro_torch.training.tree import flatten_with_path
from test_torch_dryrun_cells import _layers, _port_flat, _ref_flat, _DTYPES

FAMILY = {"lm": transformer, "gr": transformer, "gnn": gnn, "recsys": recsys}
JFAMILY = {"lm": jtransformer, "gr": jtransformer, "gnn": jgnn,
           "recsys": jrecsys}


def _flat(tree):
    return {k: (tuple(v.shape), v.dtype) for k, v in flatten_with_path(tree)}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_are_init_params_on_meta(arch):
    """Same tree, shapes and dtypes as ``init_params`` of the smoke config
    on the CPU; every leaf is meta."""
    fam = get_bundle(arch).family
    cfg = smoke_config(arch)
    specs = FAMILY[fam].param_specs(cfg)
    real = FAMILY[fam].init_params(cfg, seed=0, device="cpu")
    assert _flat(specs) == _flat(real)
    assert all(v.device.type == "meta" for _, v in flatten_with_path(specs))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_match_the_reference(arch):
    """Every architecture at full size against the reference's
    ``param_specs`` (``jax.eval_shape`` of its ``init_params``): a stacked
    layer leaf is the port's per-layer leaf with a leading layer axis."""
    fam = get_bundle(arch).family
    cfg = get_bundle(arch).config
    want = JFAMILY[fam].param_specs(jax_bundle(arch).config)
    got = _port_flat(FAMILY[fam].param_specs(cfg))
    ref = _ref_flat(want, _layers(cfg))
    assert set(ref) == set(got), sorted(set(ref) ^ set(got))[:8]
    for key, (leaf, stacked) in ref.items():
        shape = leaf.shape[1:] if stacked else leaf.shape
        assert tuple(got[key].shape) == tuple(shape), key
        assert got[key].dtype == _DTYPES[jnp.dtype(leaf.dtype)], key


def test_meta_init_keeps_the_seeded_numbers():
    """The generator is still made, and drawn in the same order, off meta."""
    cfg = smoke_config("deepseek-v2-lite-16b")
    a = transformer.init_params(cfg, seed=3, device="cpu")
    b = transformer.init_params(cfg, seed=3, device="cpu")
    for (ka, va), (kb, vb) in zip(flatten_with_path(a), flatten_with_path(b)):
        assert ka == kb and torch.equal(va, vb)
    g = gnn.init_params(smoke_config("meshgraphnet"), seed=1, device="cpu")
    assert g["processor"][0]["edge_mlp"]["l0"]["w"].abs().sum() > 0


@pytest.mark.parametrize("arch,batch,slots", [
    ("stablelm-12b", 4, 96), ("mixtral-8x7b", 2, 4096 + 256),
    ("deepseek-v2-lite-16b", 3, 64)])
def test_init_cache_on_meta_matches_the_reference(arch, batch, slots):
    cfg = get_bundle(arch).config
    want = jtransformer.init_cache(jax_bundle(arch).config, batch, slots)
    got = transformer.init_cache(cfg, batch, slots, device="meta")
    for name in ("k", "v", "c_kv", "k_rope", "slot_pos"):
        if hasattr(want, name):
            leaf = getattr(got, name)
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(getattr(want, name).shape)
            assert leaf.dtype == _DTYPES[jnp.dtype(getattr(want, name).dtype)]
    assert getattr(got, "ring", False) == getattr(want, "ring", False)


def test_adamw_state_on_meta_matches_the_reference():
    from repro.training.optimizer import adamw as jadamw

    cfg = get_bundle("static-gr").config
    got = adamw().init(transformer.param_specs(cfg))
    want = jax.eval_shape(jadamw().init, jtransformer.param_specs(
        jax_bundle("static-gr").config))
    layers = _layers(cfg)
    for part in ("m", "v"):
        ref = _ref_flat(want[part], layers)
        flat = _port_flat(got[part])
        assert set(ref) == set(flat)
        for key, (leaf, stacked) in ref.items():
            assert flat[key].dtype == torch.float32
            assert flat[key].device.type == "meta"
            assert tuple(flat[key].shape) == tuple(
                leaf.shape[1:] if stacked else leaf.shape)


def test_gnn_param_specs_follow_the_feature_width():
    cfg = dataclasses.replace(get_bundle("meshgraphnet").config,
                              node_feat_dim=602)
    specs = gnn.param_specs(cfg)
    assert tuple(specs["node_enc"]["l0"]["w"].shape) == (602, cfg.d_hidden)
