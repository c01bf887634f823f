"""Port GQA transformer against the JAX reference on converted weights.

The reference's ``init_params`` makes the weights; ``params_from_jax``
carries them into the port, so both compute with the same numbers.  The
float32 tolerance (rtol/atol 1e-4) covers the different matmul and
reduction orders of the two frameworks.  The bf16 attention cases hold the
port to the reference's float32 products of bf16 operands.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro_torch.configs.base import TransformerConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import attention, layers, transformer

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


@pytest.mark.parametrize("kw", [dict(attention="mla", kv_lora_rank=16,
                                     qk_nope_head_dim=8, qk_rope_head_dim=4,
                                     v_head_dim=8),
                                dict(sliding_window=4),
                                dict(defer_cache_write=True)])
def test_unported_paths_raise(rng, kw):
    """MLA, sliding-window and deferred-write configs now run and match
    the reference (the name is kept from when the port refused them): prefill logits and two decode steps' logits (with the
    deferred step's pending k/v against what an eager step writes)."""
    jcfg, cfg = _configs(**kw)
    jparams = jax_transformer.init_params(jcfg, jax.random.key(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    B, S = 2, 9
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 2))
    j_logits, j_cache = jax_transformer.prefill(
        jparams, jnp.asarray(tokens[:, :S]), jcfg, max_len=S + 3)
    logits, cache = transformer.prefill(
        params, torch.from_numpy(tokens[:, :S]), cfg, max_len=S + 3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    for t in range(S, S + 2):
        nxt = tokens[:, t:t + 1]
        j_out = jax_transformer.decode_step(jparams, j_cache, jnp.asarray(nxt),
                                            jcfg)
        out = transformer.decode_step(params, cache, torch.from_numpy(nxt),
                                      cfg)
        assert len(out) == len(j_out)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(j_out[0]),
                                   **TOL)
        if cfg.defer_cache_write:
            for got, want in zip(out[2], j_out[2]):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           **TOL)
        j_cache, cache = j_out[1], out[1]
        assert cache.pos == int(j_cache.pos)
        np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                      np.asarray(j_cache.slot_pos))


def _bf16_pair(x):
    """The same bf16 values for both packages."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 at each |x| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


def test_decode_attention_bf16_matches_reference(rng):
    """static-gr-3b's heads (24 over 8 KV heads, head dim 128) on a cache of
    265 slots, five of them empty.  Both products are float32 results of
    the bf16 operands, as in the reference, so the outputs agree to one
    bf16 ulp (a float32 sum taken in another order may round the last bit
    the other way) and on average to far below it."""
    B, S, H, KV, Dh = 4, 265, 24, 8, 128
    q, tq = _bf16_pair(rng.normal(size=(B, 1, H, Dh)))
    k, tk = _bf16_pair(rng.normal(size=(B, S, KV, Dh)))
    v, tv = _bf16_pair(rng.normal(size=(B, S, KV, Dh)))
    pos = np.arange(S)
    pos[260:] = -1
    want = np.asarray(jax_attention.decode_attention(
        q, k, v, jnp.asarray(pos), 259), np.float32)
    got = attention.decode_attention(tq, tk, tv, torch.from_numpy(pos), 259)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= _bf16_ulp(want)).all()
    assert diff.mean() < 1e-5


def _ulp(x: np.ndarray, bits: int) -> np.ndarray:
    """The spacing at each |x| of a float with ``bits`` significand bits."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - (bits - 1)).astype(np.float32)


@pytest.mark.parametrize("case", ["rows", "window", "float16", "float32"])
def test_decode_attention_matches_reference_masks_and_dtypes(rng, case):
    """The other inputs decode attention takes: (B, S) slot positions with
    empty slots and a (B,) position per row (the continuous engine's, one
    row with no live slot, which both softmaxes make uniform), a ring's
    window, and fp16 and float32 caches.  The tolerance is one ulp of the
    output's dtype, for the reason the bf16 test gives (float32 sums in
    another order); float32 outputs carry no cast to round, and differ by
    the sums' order alone: a few float32 ulps of the largest term (|v| < 8,
    ulp 2**-21), not of the output, which cancellation can make small."""
    B, S, H, KV, Dh = 3, 40, 6, 2, 16
    dtype = {"float16": np.float16, "float32": np.float32}.get(case)
    x = [rng.normal(size=shape) for shape in
         ((B, 1, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh))]
    if dtype is None:
        (q, tq), (k, tk), (v, tv) = map(_bf16_pair, x)
    else:
        (q, k, v), (tq, tk, tv) = ([jnp.asarray(a, dtype) for a in x],
                                   [torch.from_numpy(a.astype(dtype)) for a in x])
    pos, cur, window = np.arange(S), 33, None
    if case == "rows":
        pos = np.tile(pos, (B, 1))
        pos[0, ::3] = -1
        pos[1, 30:] = -1
        cur = np.array([33, 39, -1])
    elif case == "window":  # a ring of S slots written up to position 57
        pos = np.where(np.arange(S) <= 57 % S, np.arange(S) + S,
                       np.arange(S))
        cur, window = 57, 16
    want = np.asarray(jax_attention.decode_attention(
        q, k, v, jnp.asarray(pos), jnp.asarray(cur), window=window),
        np.float32)
    got = attention.decode_attention(tq, tk, tv, torch.from_numpy(pos),
                                     torch.from_numpy(cur) if case == "rows"
                                     else cur, window=window)
    assert got.dtype == tq.dtype
    diff = np.abs(got.float().numpy() - want)
    if case == "float32":
        assert np.abs(x[2]).max() < 8 and diff.max() <= 4 * 2.0 ** -21
    else:
        assert (diff <= _ulp(want, 11 if case == "float16" else 8)).all()


@pytest.mark.parametrize("chunk_kv", [1024, 16])
def test_chunked_attention_bf16_matches_reference(rng, chunk_kv):
    """Prefill attention in bf16, one key chunk (1024) or four (16).  The
    port streams key chunks through the reference's online softmax:
    unnormalized probabilities are cast to bf16 before the float32 PV
    product and divided by their float32 sum at the end.  The score sums
    run in another order, so a probability near a bf16 rounding boundary
    can round the other way; the tolerance is one bf16 ulp in [0.5, 1)
    (2**-8) per element and 1e-5 on average."""
    q, tq = _bf16_pair(rng.normal(size=(2, 64, 8, 32)))
    k, tk = _bf16_pair(rng.normal(size=(2, 64, 2, 32)))
    v, tv = _bf16_pair(rng.normal(size=(2, 64, 2, 32)))
    want = np.asarray(jax_attention.chunked_causal_attention(
        q, k, v, chunk_q=16, chunk_kv=chunk_kv), np.float32)
    got = attention.chunked_causal_attention(tq, tk, tv, chunk_q=16,
                                             chunk_kv=chunk_kv)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 2.0 ** -8
    assert diff.mean() < 1e-5
