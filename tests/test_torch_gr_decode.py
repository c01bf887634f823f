"""Port ``gr_decode_step`` (the prefix-shared GR decode step) against JAX.

The reference's ``init_params`` makes the smoke static-gr weights (float32)
and ``params_from_jax`` carries them into the port.  Tolerance rtol = atol
= 2e-4 is the reference's own for this step's layout test
(``tests/test_perf_variants.py``); the two beam layouts are one memory
layout in the port, so there they are held bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import transformer as jax_transformer
from repro_torch.configs.base import MoEConfig, TransformerConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer

TOL = dict(rtol=2e-4, atol=2e-4)
B, M, S_H, S_SID = 2, 3, 6, 4


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(smoke_config("static-gr"), dtype="float32")
    jparams = jax_transformer.init_params(jcfg, jax.random.key(0))
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    n, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(hk=f(n, B, S_H, KV, hd), hv=f(n, B, S_H, KV, hd),
                bk=f(n, B * M, S_SID, KV, hd), bv=f(n, B * M, S_SID, KV, hd),
                toks=rng.integers(0, cfg.vocab_size, (B * M, 1)).astype(
                    np.int32))


def _port(params, cfg, x, step, batched):
    shape = ((cfg.n_layers, B, M) if batched else (cfg.n_layers, B * M))
    bk = torch.from_numpy(x["bk"].copy()).reshape(shape + x["bk"].shape[2:])
    bv = torch.from_numpy(x["bv"].copy()).reshape(shape + x["bv"].shape[2:])
    c = dataclasses.replace(cfg, gr_batched_beams=batched)
    logits, nbk, nbv = transformer.gr_decode_step(
        params, torch.from_numpy(x["hk"]), torch.from_numpy(x["hv"]), bk, bv,
        torch.from_numpy(x["toks"]), step, c)
    flat = (cfg.n_layers, B * M) + x["bk"].shape[2:]
    return logits.numpy(), nbk.reshape(flat).numpy(), nbv.reshape(flat).numpy()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("step", [0, 1, S_SID - 1])
def test_gr_decode_step_matches_reference(model, batched, step):
    jcfg, jparams, cfg, params = model
    x = _inputs(cfg, seed=step)
    jc = dataclasses.replace(jcfg, gr_batched_beams=batched)
    shape = ((cfg.n_layers, B, M) if batched else (cfg.n_layers, B * M))
    jbk = jnp.asarray(x["bk"].reshape(shape + x["bk"].shape[2:]))
    jbv = jnp.asarray(x["bv"].reshape(shape + x["bv"].shape[2:]))
    want_l, want_k, want_v = jax_transformer.gr_decode_step(
        jparams, jnp.asarray(x["hk"]), jnp.asarray(x["hv"]), jbk, jbv,
        jnp.asarray(x["toks"]), jnp.asarray(step, jnp.int32), jc)
    got_l, got_k, got_v = _port(params, cfg, x, step, batched)
    flat = got_k.shape
    diff = float(np.max(np.abs(got_l - np.asarray(want_l))))
    print(f"layout {'batched' if batched else 'flat'}, sid_step {step}: "
          f"largest logit difference {diff:.3g}")
    assert got_l.shape == (B * M, 1, cfg.vocab_size)
    np.testing.assert_allclose(got_l, np.asarray(want_l), **TOL)
    np.testing.assert_allclose(got_k, np.asarray(want_k).reshape(flat), **TOL)
    np.testing.assert_allclose(got_v, np.asarray(want_v).reshape(flat), **TOL)


def test_gr_batched_beam_layout_equivalence(model):
    """(L, B, M, S, KV, hd) beam layout == flat (L, B*M, S, KV, hd)."""
    _, _, cfg, params = model
    x = _inputs(cfg, seed=7)
    flat = _port(params, cfg, x, 1, batched=False)
    batched = _port(params, cfg, x, 1, batched=True)
    for a, b in zip(flat, batched):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t", [0, 1, 2])
def test_gr_decode_step_matches_tiled_decode_step(model, t):
    """``gr_decode_step`` at ``sid_step = t`` equals the retriever's
    ``decode_step`` over the M-tiled history cache at search step ``t + 1``
    (float32; the two reduce over different widths, so within 2e-4)."""
    _, _, cfg, params = model
    rng = np.random.default_rng(11 + t)
    hist = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S_H)))
    L = S_SID
    _, cache = transformer.prefill(params, hist, cfg, max_len=S_H + L + 1)
    KV, hd, n = cfg.n_kv_heads, cfg.resolved_head_dim(), cfg.n_layers
    hk, hv = cache.k[:, :, :S_H].clone(), cache.v[:, :, :S_H].clone()
    tiled = dataclasses.replace(cache, k=cache.k.repeat_interleave(M, dim=1),
                                v=cache.v.repeat_interleave(M, dim=1))
    bk = torch.zeros((n, B * M, L, KV, hd))
    bv = torch.zeros_like(bk)
    for s in range(t + 1):  # the same tokens through both, step by step
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B * M, 1)).astype(np.int32))
        want, tiled = transformer.decode_step(params, tiled, toks, cfg)
        got, bk, bv = transformer.gr_decode_step(params, hk, hv, bk, bv, toks,
                                                 s, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(
        bk[:, :, :t + 1].numpy(),
        tiled.k[:, :, S_H:S_H + t + 1].numpy(), **TOL)


def test_gr_decode_step_rejects_moe(model):
    _, _, cfg, params = model
    moe = dataclasses.replace(cfg, moe=MoEConfig(n_experts=4, top_k=2,
                                                 d_expert=16))
    x = _inputs(cfg)
    with pytest.raises(NotImplementedError, match="MoE"):
        transformer.gr_decode_step(
            params, torch.from_numpy(x["hk"]), torch.from_numpy(x["hv"]),
            torch.from_numpy(x["bk"]), torch.from_numpy(x["bv"]),
            torch.from_numpy(x["toks"]), 0, moe)


def test_gr_decode_step_never_repeats_the_history():
    """GQA is a grouped view of the queries: no repeat of K/V over the
    groups or the beams appears in the step."""
    import inspect

    src = inspect.getsource(transformer.gr_decode_step)
    assert "repeat" not in src.split('"""')[2]
    assert ".expand(" not in src
