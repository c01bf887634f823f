"""The port's LM families (MoE, MLA, sliding-window ring caches, deferred
cache writes; ``repro_torch.models.transformer``) and its config registry
against the reference on carried-over float32 weights.

The reference's ``init_params`` makes the weights and ``params_from_jax``
carries them into the port, so both compute with the same numbers; the
reference's functions run under ``jax.jit`` (the same code, compiled once
per config).  Tolerance: logits, hidden states and caches within rtol/atol
1e-4 (float32, other matmul and reduction orders; the port's test of the
GQA path uses the same).  The decode variants (ring, deferred writes) and
the gradients are in ``test_torch_lm_variants.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import LM_SHAPES
from repro.models import transformer as jax_transformer
from repro_torch import configs
from repro_torch.configs.base import TransformerConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer

TOL = dict(rtol=1e-4, atol=1e-4)
LM_ARCHS = ["stablelm-12b", "qwen1.5-110b", "codeqwen1.5-7b",
            "deepseek-v2-lite-16b", "mixtral-8x7b"]



@functools.partial(jax.jit, static_argnums=(2,))
def _j_forward_and_loss(params, tokens, cfg):
    x, _, aux = jax_transformer.forward(params, tokens, cfg)
    return x, aux, jax_transformer.lm_loss(params, tokens, cfg)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _j_prefill_and_decode(params, tokens, cfg, prompt_len):
    """Prefill ``tokens[:, :prompt_len]`` into a cache of S slots, then one
    decode step per further token: every step's logits and cache."""
    S = tokens.shape[1]
    logits, cache = jax_transformer.prefill(params, tokens[:, :prompt_len],
                                            cfg, S)
    out = [(logits, cache)]
    for t in range(prompt_len, S):
        out.append(jax_transformer.decode_step(params, out[-1][1],
                                               tokens[:, t:t + 1], cfg))
    return out


@functools.lru_cache(maxsize=None)
def _model(arch, **kw):
    """(JAX config, port config, JAX params, port params) of an arch's smoke
    config with ``kw`` replaced; one reference init per arch."""
    jcfg = dataclasses.replace(jax_configs.smoke_config(arch), **kw)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    jparams = _jax_params(arch)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, cfg, jparams, params


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.jit(jax_transformer.init_params, static_argnums=(0,))(
        jax_configs.smoke_config(arch), jax.random.key(0))


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _cache_arrays(cache):
    return ((cache.c_kv, cache.k_rope) if hasattr(cache, "c_kv")
            else (cache.k, cache.v))


def test_registry_lists_equal_the_reference():
    assert list(configs.ARCHS) == list(jax_configs.ARCHS)
    assert configs.ASSIGNED == jax_configs.ASSIGNED
    assert len(configs.ASSIGNED) == 10


# fields of the port's own (the reference lacks them) and their defaults,
# which compute what the reference computes
PORT_ONLY = {"rope_scaling": None, "moe": {"norm_topk_prob": True}}


def _as_reference(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` with the port's own fields checked at
    their defaults and dropped."""
    d = dataclasses.asdict(cfg)
    for key, default in PORT_ONLY.items():
        if key not in d:
            continue
        if isinstance(default, dict):
            for k, v in default.items():
                if d[key] is not None:
                    assert d[key].pop(k) == v, (key, k)
        else:
            assert d.pop(key) == default, key
    return d


@pytest.mark.parametrize("arch", list(jax_configs.ARCHS))
def test_registry_entry_equals_the_reference(arch):
    """Family, shapes, config and smoke config field for field (the port's
    own fields at the defaults that compute the reference's function);
    shape applicability for every shape of every family; parameter
    counts."""
    jb, b = jax_configs.get_bundle(arch), configs.get_bundle(arch)
    assert b.family == jb.family and b.arch_id == jb.arch_id
    assert ([dataclasses.asdict(s) for s in b.shapes]
            == [dataclasses.asdict(s) for s in jb.shapes])
    assert _as_reference(b.config) == dataclasses.asdict(jb.config)
    assert type(b.config).__name__ == type(jb.config).__name__
    smoke, jsmoke = configs.smoke_config(arch), jax_configs.smoke_config(arch)
    assert _as_reference(smoke) == dataclasses.asdict(jsmoke)
    names = {s.name for s in LM_SHAPES + jb.shapes}
    for name in sorted(names):
        assert (configs.supports_shape(arch, name)
                == jax_configs.supports_shape(arch, name))
    if b.family in ("lm", "gr"):
        for c, jc in ((b.config, jb.config), (smoke, jsmoke)):
            assert c.param_count() == jc.param_count()
            assert c.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_paths_match_reference(arch):
    """forward (hidden and aux loss), lm_loss, prefill (logits and cache)
    and three decode steps (logits, cache, slot positions)."""
    jcfg, cfg, jparams, params = _model(arch)
    B, S = 2, 16
    tokens = _tokens(cfg, B, S)
    jx, jaux, jl = _j_forward_and_loss(jparams, jnp.asarray(tokens), jcfg)
    x, _, aux = transformer.forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == (cfg.moe is not None)
    np.testing.assert_allclose(
        float(transformer.lm_loss(params, torch.from_numpy(tokens), cfg)),
        float(jl), **TOL)

    P = S - 3
    steps = _j_prefill_and_decode(jparams, jnp.asarray(tokens), jcfg, P)
    logits, cache = transformer.prefill(params, torch.from_numpy(
        tokens[:, :P]), cfg, max_len=S)
    for t, (j_logits, j_cache) in zip(range(P, S + 1), steps):
        if t > P:
            logits, cache = transformer.decode_step(
                params, cache, torch.from_numpy(tokens[:, t - 1:t]), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **TOL)
        for got, want in zip(_cache_arrays(cache), _cache_arrays(j_cache)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                      np.asarray(j_cache.slot_pos))
        assert cache.pos == int(j_cache.pos)
