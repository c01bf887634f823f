"""The port's decode variants and training gradients of the LM families
(``repro_torch.models.transformer``) against the reference, the contract of
its ``tests/test_perf_variants.py`` and ``test_sliding_window_ring_cache``:
the sliding-window ring past its window, deferred cache writes (GQA, MLA
and the ring), ``decode_split_k`` on one device, and ``lm_loss``
gradients of the MoE archs against ``jax.grad``, on carried-over float32
weights (``test_torch_lm_families._model``).

Tolerances: logits, pending k/v and caches within rtol/atol 1e-4 (float32,
other matmul and reduction orders); a deferred step against the eager one
within 2e-4, the reference test's; gradients within 1e-4 of the largest
magnitude of each tensor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jax_transformer
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer
from repro_torch.training.tree import flatten_with_path
from test_torch_lm_families import TOL, _cache_arrays, _model, _tokens

j_prefill = jax.jit(jax_transformer.prefill, static_argnums=(2, 3))
j_decode = jax.jit(jax_transformer.decode_step, static_argnums=(3,))


def test_ring_decode_past_the_window_matches_reference():
    """Mixtral's ring (window 8 at smoke size): prefill 16 tokens into a
    24-position budget, then decode to position 23, wrapping the ring; each
    step's logits, ring and slot positions against the reference's, and the
    last logits against the port's full-context forward (the window masks
    the rest)."""
    jcfg, cfg, jparams, params = _model("mixtral-8x7b")
    assert cfg.sliding_window == 8
    B, S = 1, 24
    tokens = _tokens(cfg, B, S)
    _, j_cache = j_prefill(jparams, jnp.asarray(tokens[:, :16]), jcfg, S)
    _, cache = transformer.prefill(params, torch.from_numpy(tokens[:, :16]),
                                   cfg, max_len=S)
    assert cache.ring and cache.k.shape[2] == cfg.sliding_window
    for t in range(16, S):
        nxt = tokens[:, t:t + 1]
        j_logits, j_cache = j_decode(jparams, j_cache, jnp.asarray(nxt), jcfg)
        logits, cache = transformer.decode_step(params, cache,
                                                torch.from_numpy(nxt), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **TOL)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(j_cache.k),
                                   **TOL)
        np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                      np.asarray(j_cache.slot_pos))
    assert cache.k.shape[2] == cfg.sliding_window
    assert sorted(cache.slot_pos.tolist()) == list(range(S - 8, S))
    x, _, _ = transformer.forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(logits.numpy(), (x[:, -1:] @ params[
        "unemb"]).numpy(), **TOL)


@pytest.mark.parametrize("arch", ["stablelm-12b", "deepseek-v2-lite-16b",
                                  "mixtral-8x7b"])
def test_deferred_decode_matches_reference(arch):
    """``defer_cache_write`` (the reference's
    ``test_deferred_commit_decode_equivalence`` and
    ``test_deferred_commit_mla_equivalence``): logits and pending k/v (or
    latents) against the reference's deferred step; the port's cache
    arrays untouched, bit for bit; the logits equal the eager step's and
    the pending rows equal what the eager step writes.  Mixtral's step
    runs on its ring, wrapped."""
    jcfg, cfg, jparams, params = _model(arch, defer_cache_write=True)
    eager = dataclasses.replace(cfg, defer_cache_write=False)
    B, S = 2, 12
    tokens = _tokens(cfg, B, S + 1)
    _, j_cache = j_prefill(jparams, jnp.asarray(tokens[:, :S]), jcfg, S + 4)
    _, cache = transformer.prefill(params, torch.from_numpy(tokens[:, :S]),
                                   cfg, max_len=S + 4)
    before = [a.clone() for a in _cache_arrays(cache)]
    nxt = tokens[:, S:S + 1]
    j_logits, _, j_pending = j_decode(jparams, j_cache, jnp.asarray(nxt),
                                      jcfg)
    logits, new, pending = transformer.decode_step(
        params, cache, torch.from_numpy(nxt), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    for got, want in zip(pending, j_pending):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 _cache_arrays(cache)))
    assert new.pos == S + 1
    e_logits, e_cache = transformer.decode_step(params, cache,
                                                torch.from_numpy(nxt), eager)
    np.testing.assert_allclose(logits.numpy(), e_logits.numpy(),
                               rtol=2e-4, atol=2e-4)
    slot = int(torch.nonzero(e_cache.slot_pos == S)[0, 0])
    for got, arr in zip(pending, _cache_arrays(e_cache)):
        np.testing.assert_allclose(got[:, :, 0].numpy(),
                                   arr[:, :, slot].numpy(), **TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_lm_loss_gradients_match_jax_grad(arch):
    """``lm_loss`` gradients of an MLA + MoE arch and of mixtral (sliding
    window + MoE) against ``jax.grad``, under the layers' recompute; the
    reference's gradient tree is carried into the port's layout."""
    jcfg, cfg, jparams, _ = _model(arch)
    tokens = _tokens(cfg, 2, 16)
    want = jax.jit(jax.grad(jax_transformer.lm_loss), static_argnums=(2,))(
        jparams, jnp.asarray(tokens), jcfg)
    want = params_from_jax(jax.tree.map(np.asarray, want), cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    leaves = [v.requires_grad_(True) for _, v in flatten_with_path(params)]
    grads = torch.autograd.grad(transformer.lm_loss(
        params, torch.from_numpy(tokens), cfg), leaves)
    for (key, w), g in zip(flatten_with_path(want), grads):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, key
    assert float(grads[-1].abs().max()) > 0


def test_split_k_flag_is_a_noop():
    """``decode_split_k`` only constrains JAX shardings: one device's step
    is unchanged, bit for bit."""
    _, cfg, _, params = _model("qwen1.5-110b")
    tokens = _tokens(cfg, 2, 7)
    split = dataclasses.replace(cfg, decode_split_k=True)
    out = []
    for c in (cfg, split):
        _, cache = transformer.prefill(params, torch.from_numpy(
            tokens[:, :6]), c, max_len=10)
        out.append(transformer.decode_step(params, cache, torch.from_numpy(
            tokens[:, 6:]), c)[0])
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_init_params_layout_matches_reference(arch):
    """The port's seeded init has the converted reference tree's layout:
    dense layers first (deepseek's one), then MoE layers; MLA projections;
    a float32 router; expert weights at the reference's He scale."""
    _, cfg, _, ref = _model(arch)
    got = transformer.init_params(cfg, seed=0, device="cpu")
    shapes = [(k, tuple(v.shape), v.dtype) for k, v in flatten_with_path(got)]
    assert shapes == [(k, tuple(v.shape), v.dtype)
                      for k, v in flatten_with_path(ref)]
    n_dense = cfg.moe.first_dense_layers
    assert all(("ffn" in p) == (i < n_dense)
               for i, p in enumerate(got["layers"]))
    moe = got["layers"][-1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w1"].std().item() == pytest.approx(
        (2 / cfg.moe.n_experts) ** 0.5, rel=0.1)
    assert ("w_kv_b" in got["layers"][0]["attn"]) == (cfg.attention == "mla")


@pytest.mark.parametrize("window,chunk_kv", [(16, 8), (12, 4), (40, 16)])
def test_windowed_chunked_attention_matches_reference(window, chunk_kv):
    """Sliding-window prefill attention where key chunks wholly before a
    query chunk's window are skipped (the smoke configs' window of 8 with
    chunks of 8 never skips one), against the reference's, which runs
    every chunk: float32, rtol/atol 1e-5."""
    from repro.models import attention as jax_attention
    from repro_torch.models import attention

    rng = np.random.default_rng(window)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (
        (2, 64, 4, 8), (2, 64, 2, 8), (2, 64, 2, 6)))
    want = jax_attention.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk_q=8,
        chunk_kv=chunk_kv, window=window)
    got = attention.chunked_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        chunk_q=8, chunk_kv=chunk_kv, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
