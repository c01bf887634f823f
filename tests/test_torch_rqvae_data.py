"""Port data pipeline and RQ-VAE tokenizer against the JAX reference.

The data modules are numpy copies: their arrays must equal the
reference's bit for bit under one seed.  RQ-VAE runs on weights carried
over from the reference (``convert.rqvae_params_from_jax``): the loss and
its gradients within rtol 1e-5 (atol 1e-6), the Semantic IDs equal (the
nearest-codeword argmin keeps the lowest index on ties), the dedup tokens
equal, and ``train_rqvae`` from the reference's own initial weights on the
reference's batch stream with losses within rtol 1e-3 after 200 AdamW
steps (float32 rounding in two summation orders, compounded over the
steps).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RQVAEConfig as JaxRQVAEConfig
from repro.data import amazon as jax_amazon
from repro.data import loader as jax_loader
from repro.data import synthetic as jax_synthetic
from repro.models import rqvae as jax_rqvae
from repro.scenarios.stages import train_rqvae as jax_train_rqvae
from repro_torch.configs import RQVAEConfig
from repro_torch.convert import rqvae_params_from_jax
from repro_torch.data import (ShardedBatcher, make_cold_start_dataset,
                              make_item_corpus, make_user_sequences)
from repro_torch.models import rqvae
from repro_torch.scenarios.stages import train_rqvae
from repro_torch.training.tree import flatten_with_path

RTOL, ATOL = 1e-5, 1e-6
JCFG = JaxRQVAEConfig(feat_dim=16, latent_dim=8, n_levels=3,
                      codebook_size=32, enc_hidden=(32, 16))
CFG = RQVAEConfig(**dataclasses.asdict(JCFG))


def _pair(seed=1):
    jp = jax_rqvae.init_params(JCFG, jax.random.key(seed))
    return jp, rqvae_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _feats(n=300, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 16)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# data: bit-equal to the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_corpus_and_sequences_equal_reference(seed):
    a = make_item_corpus(np.random.default_rng(seed), 500, 12, 8)
    b = jax_synthetic.make_item_corpus(np.random.default_rng(seed), 500, 12, 8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    s1 = make_user_sequences(np.random.default_rng(seed), 40, 9, a[1])
    s2 = jax_synthetic.make_user_sequences(np.random.default_rng(seed), 40,
                                           9, b[1])
    np.testing.assert_array_equal(s1, s2)


@pytest.mark.parametrize("seed,cold_frac", [(0, 0.02), (5, 0.05)])
def test_cold_start_dataset_equals_reference(seed, cold_frac):
    kw = dict(seed=seed, n_items=400, n_clusters=16, feat_dim=8,
              n_users=700, seq_len=6, cold_frac=cold_frac)
    a, b = make_cold_start_dataset(**kw), jax_amazon.make_cold_start_dataset(
        **kw)
    for f in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    np.testing.assert_array_equal(a.age_days, b.age_days)
    assert a.n_items == b.n_items


def test_sharded_batcher_equals_reference_and_resumes():
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(50, 3)), "y": np.arange(50)}
    for hosts, host in ((1, 0), (2, 1)):
        a = ShardedBatcher(data, 8, seed=4, n_hosts=hosts, host_id=host)
        b = jax_loader.ShardedBatcher(data, 8, seed=4, n_hosts=hosts,
                                      host_id=host)
        for _ in range(14):  # crosses an epoch boundary (6 batches/epoch)
            x, y = next(a), next(b)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        assert a.state() == b.state()
    c = ShardedBatcher(data, 8, seed=4)
    c.restore(a.state())  # exact resume from a data cursor
    d = jax_loader.ShardedBatcher(data, 8, seed=4)
    d.restore(a.state())
    np.testing.assert_array_equal(next(c)["y"], next(d)["y"])
    with pytest.raises(ValueError, match="length mismatch"):
        ShardedBatcher({"a": np.zeros(3), "b": np.zeros(4)}, 1)


# ---------------------------------------------------------------------------
# RQ-VAE
# ---------------------------------------------------------------------------
def test_init_params_layout_equals_reference():
    jp, _ = _pair()
    tp = rqvae.init_params(CFG, seed=0, device="cpu")
    want = {k: tuple(v.shape) for k, v in flatten_with_path(
        jax.tree.map(np.asarray, jp))}
    got = {k: tuple(v.shape) for k, v in flatten_with_path(tp)}
    assert got == want
    assert all(v.dtype == torch.float32 for _, v in flatten_with_path(tp))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rqvae.init_params(CFG)


def test_rqvae_loss_and_gradients_match_jax():
    jp, tp = _pair()
    f = _feats()
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_rqvae.rqvae_loss(p, jnp.asarray(f), JCFG)))(jp)
    leaves = [l for _, l in flatten_with_path(tp)]
    for p in leaves:
        p.requires_grad_(True)
    tl = rqvae.rqvae_loss(tp, torch.from_numpy(f), CFG)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jg)))
    for (k, _), g in zip(flatten_with_path(tp), tg):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_encode_and_decode_match_jax():
    jp, tp = _pair()
    f = _feats(seed=2)
    jsids = np.asarray(jax_rqvae.encode_to_sids(jp, jnp.asarray(f), JCFG))
    tsids = rqvae.encode_to_sids(tp, torch.from_numpy(f), CFG)
    assert tsids.dtype == torch.int32
    np.testing.assert_array_equal(tsids.numpy(), jsids)
    rec = rqvae.decode_from_sids(tp, tsids, CFG)
    np.testing.assert_allclose(
        rec.numpy(), np.asarray(jax_rqvae.decode_from_sids(
            jp, jnp.asarray(jsids), JCFG)), rtol=RTOL, atol=ATOL)


def test_argmin_tie_keeps_the_lowest_index():
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    idx, q = rqvae._quantize(torch.tensor([[2.0, 0.0], [0.5, 0.5]]), cb)
    assert idx.tolist() == [0, 0]  # rows 0 and 2 tie; (0.5, 0.5): all tie


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_dedup_tokens_equal_reference(seed):
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 3, (200, 2))  # many collisions
    got = rqvae.assign_dedup_tokens(levels, 8)
    np.testing.assert_array_equal(got, jax_rqvae.assign_dedup_tokens(
        levels, 8))
    assert np.unique(got, axis=0).shape[0] == min(
        200, np.unique(levels, axis=0).shape[0] * 8)


def test_train_rqvae_losses_match_reference():
    f = _feats(n=500, seed=4)
    jlines, tlines = [], []
    jp = jax_train_rqvae(f, JCFG, steps=201, seed=3, lr=3e-3, batch=64,
                         log=jlines.append)
    init = jax_rqvae.init_params(JCFG, jax.random.key(3))
    tp = train_rqvae(f, CFG, steps=201, seed=3, lr=3e-3, batch=64,
                     log=tlines.append, device="cpu",
                     params=rqvae_params_from_jax(
                         jax.tree.map(np.asarray, init), device="cpu"))
    loss = lambda lines: [float(re.search(r"loss ([\d.]+)", ln).group(1))
                          for ln in lines]
    assert len(tlines) == len(jlines) == 3  # steps 0, 100, 200
    np.testing.assert_allclose(loss(tlines), loss(jlines), rtol=1e-3)
    final_j = float(jax_rqvae.rqvae_loss(jp, jnp.asarray(f), JCFG))
    final_t = float(rqvae.rqvae_loss(tp, torch.from_numpy(f), CFG))
    np.testing.assert_allclose(final_t, final_j, rtol=1e-3)
    assert final_t < loss(tlines)[0]
