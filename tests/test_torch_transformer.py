"""Port GQA transformer against the JAX reference on converted weights.

The reference's ``init_params`` makes the weights; ``params_from_jax``
carries them into the port, so both compute with the same numbers.  The
float32 tolerance (rtol/atol 1e-4) covers the different matmul and
reduction orders of the two frameworks (and the port's exact per-chunk
softmax where the reference streams an online softmax).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro_torch.configs.base import TransformerConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import layers, transformer

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(**kw):
    base = dict(name="gqa-tiny", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=40, dtype="float32",
                attn_chunk_q=8, attn_chunk_kv=8)
    base.update(kw)
    jcfg = JaxTransformerConfig(**base)
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("tie,bias", [(True, False), (False, True)])
def test_prefill_and_decode_match_reference(rng, tie, bias):
    jcfg, cfg = _configs(tie_embeddings=tie, qkv_bias=bias)
    jparams = jax_transformer.init_params(jcfg, jax.random.key(1))
    if bias:  # non-zero biases so the bias path is exercised
        jparams["dense_layers"]["attn"] = jax.tree.map(
            lambda a: a + 0.1 if a.ndim == 2 else a,
            jparams["dense_layers"]["attn"])
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    B, S, max_len = 3, 12, 16
    tokens = rng.integers(0, cfg.vocab_size, (B, S))

    j_logits, j_cache = jax_transformer.prefill(jparams, jnp.asarray(tokens),
                                                jcfg, max_len=max_len)
    logits, cache = transformer.prefill(params, torch.from_numpy(tokens), cfg,
                                        max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(j_cache.k), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(j_cache.v), **TOL)
    np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                  np.asarray(j_cache.slot_pos))
    assert cache.pos == int(j_cache.pos)

    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1))
        j_logits, j_cache = jax_transformer.decode_step(
            jparams, j_cache, jnp.asarray(nxt), jcfg)
        logits, cache = transformer.decode_step(
            params, cache, torch.from_numpy(nxt), cfg)
        assert logits.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(j_cache.k),
                                   **TOL)
        np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                      np.asarray(j_cache.slot_pos))


def test_rope_rotates_interleaved_pairs(rng):
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5)[None] + 7
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_init_params_shapes_match_reference():
    jcfg, cfg = _configs(tie_embeddings=False, qkv_bias=True)
    want = jax.tree.map(np.asarray, jax_transformer.init_params(
        jcfg, jax.random.key(0)))
    got = transformer.init_params(cfg, seed=0, device="cpu")
    ref = params_from_jax(want, cfg, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), (got, ref))
    assert shapes[0] == shapes[1]
    # same distributions: unit norm scales, zero biases, He-scaled weights
    assert torch.equal(got["layers"][0]["ln_attn"]["scale"],
                       torch.ones(cfg.d_model))
    assert not got["layers"][1]["attn"]["wq"]["b"].any()
    w = got["layers"][0]["ffn"]["w1"]
    assert w.std().item() == pytest.approx((2 / cfg.d_model) ** 0.5, rel=0.1)
    again = transformer.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["emb"], got["emb"])  # seeded


@pytest.mark.parametrize("kw", [dict(attention="mla"),
                                dict(sliding_window=4),
                                dict(defer_cache_write=True)])
def test_unported_paths_raise(kw):
    _, cfg = _configs(**kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        transformer.init_params(cfg, device="cpu")
