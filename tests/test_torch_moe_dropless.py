"""The port's serving of a MoE model at its published settings
(DeepSeek-V2-Lite): dropless routing, ``norm_topk_prob``, YaRN, and the
retriever's tiling and reordering of whichever cache the model keeps.

Float32 tolerances are 1e-5 of the largest magnitude compared: the two sides
compute the same products, summed in another order (one grouped product
against one product a token).  The comparisons with the plain reference
decoder are in ``gpubench/tests/test_gpubench_mla_moe.py``; the capacity
path, still the default, is held to the JAX reference in
``test_torch_moe.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig, RopeScaling, TransformerConfig
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.decoding import DecodePolicy
from repro_torch.models import kvcache, moe, transformer
from repro_torch.models.layers import (
    apply_rope,
    rope_frequencies,
    yarn_correction_range,
    yarn_frequencies,
    yarn_mscale,
)
from repro_torch.serving import GenerativeRetriever, generative_retrieval

D, E, K, FE = 32, 8, 2, 16
YARN = RopeScaling(factor=40, original_max_position_embeddings=4096,
                   beta_fast=32, beta_slow=1, mscale=0.707,
                   mscale_all_dim=0.707)


def _close(got, want, rel=1e-5):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= rel * scale


def _moe_params(seed=0, router_std=1.0, shared=False):
    g = torch.Generator().manual_seed(seed)
    cfg = MoEConfig(n_experts=E, top_k=K, d_expert=FE,
                    n_shared=1 if shared else 0)
    p = moe.moe_init(g, D, cfg, torch.float32)
    p["router"] = p["router"] * router_std
    return p


def _plain(p, x, weights, idx):
    """Each token's weighted routed-expert outputs, one token at a time."""
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for w, e in zip(weights[t], idx[t]):
            h = F.silu(x[t] @ p["w1"][e]) * (x[t] @ p["w3"][e])
            out[t] += w * (h @ p["w2"][e])
    return out


@pytest.mark.parametrize("norm", [False, True])
def test_dropless_weights_are_the_softmax_top_k(norm):
    """``norm_topk_prob=False``: the raw softmax weights; True: divided by
    their sum.  Nothing is dropped, at any batch."""
    p = _moe_params(1)
    cfg = MoEConfig(n_experts=E, top_k=K, d_expert=FE, capacity_factor=None,
                    norm_topk_prob=norm)
    x = torch.randn(40, D, generator=torch.Generator().manual_seed(2))
    probs = torch.softmax(x @ p["router"], dim=-1)
    w, i = torch.topk(probs, K, dim=-1)
    assert float(w.sum(-1).max()) < 0.99  # the raw weights do not sum to 1
    if norm:
        w = w / w.sum(-1, keepdim=True)
    got, _ = moe.moe_ffn(p, x, cfg)
    _close(got, _plain(p, x, w, i))


def test_dropless_batch_on_one_expert_loses_nothing():
    """A zero router sends every token to expert 0 (ties to the lower
    expert) with weight 1 / E: dropless computes all of them, where the
    capacity path keeps only its capacity's worth."""
    p = _moe_params(3)
    p["router"] = torch.zeros_like(p["router"])
    x = torch.randn(64, D, generator=torch.Generator().manual_seed(4))
    want = _plain(p, x, torch.full((64, 1), 1.0 / E),
                  torch.zeros((64, 1), dtype=torch.long))
    one = dict(n_experts=E, top_k=1, d_expert=FE, norm_topk_prob=False)
    got, _ = moe.moe_ffn(p, x, MoEConfig(capacity_factor=None, **one))
    _close(got, want)
    capped, _ = moe.moe_ffn(p, x, MoEConfig(**one))
    cap = moe.expert_capacity(64, MoEConfig(**one))
    assert cap < 64
    _close(capped[:cap], want[:cap])
    assert bool((capped[cap:] == 0).all())


def test_dropless_aux_loss_only_where_gradients_are_recorded():
    """Served (no grad) the loss is a zero scalar; with gradients it is the
    load-balancing loss of the capacity path over one group."""
    p = _moe_params(10, router_std=3.0)
    cfg = MoEConfig(n_experts=E, top_k=K, d_expert=FE, capacity_factor=None)
    x = torch.randn(12, D, generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        y0, aux0 = moe.moe_ffn(p, x, cfg)
    y1, aux1 = moe.moe_ffn(p, x, cfg)
    assert torch.equal(y0, y1)
    assert aux0.dtype == torch.float32 and aux0.shape == () and aux0 == 0
    probs = torch.softmax(x @ p["router"], dim=-1)
    counts = torch.bincount(torch.topk(probs, K, -1).indices.reshape(-1),
                            minlength=E)
    want = cfg.router_aux_weight * E * (
        probs.mean(dim=0) * counts.float() / (12 * K)).sum()
    _close(aux1, want)
    assert aux1 > 0


def test_routing_counter_only_while_a_profiler_records():
    p = _moe_params(8, router_std=3.0)
    cfg = MoEConfig(n_experts=E, top_k=K, d_expert=FE, capacity_factor=None)
    x = torch.randn(5, D, generator=torch.Generator().manual_seed(9))
    moe.reset_routing()
    moe.moe_ffn(p, x, cfg, "decode")
    assert moe.routing_counts() == {}
    hit = len(torch.unique(torch.topk(x @ p["router"], K, -1).indices))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        moe.moe_ffn(p, x, cfg, "decode")
        moe.moe_ffn(p, x, cfg, "decode")
        moe.moe_ffn(p, x[:1], cfg)
    assert moe.routing_counts() == {
        "decode": {"experts_hit": 2 * hit, "assignments": 20, "passes": 2},
        "prefill": {"experts_hit": K, "assignments": K, "passes": 1}}
    moe.reset_routing()


def test_yarn_constants_at_the_published_sizes():
    """DeepSeek-V2-Lite: 64 rotary dims, theta 1e4, YaRN factor 40 over
    4,096 positions, betas 32 and 1, mscale 0.707."""
    assert yarn_correction_range(64, 1e4, YARN) == (10, 23)
    assert yarn_mscale(40, 0.707) ** 2 == pytest.approx(1.58963, abs=1e-5)
    f, base = yarn_frequencies(64, 1e4, YARN), rope_frequencies(64, 1e4)
    assert torch.equal(f[:11], base[:11])  # below the ramp: unchanged
    assert torch.allclose(f[23:], base[23:] / 40, rtol=1e-6)
    ramp = (torch.arange(11, 23) - 10) / 13
    assert torch.allclose(f[11:23], base[11:23] * (1 - ramp + ramp / 40),
                          rtol=1e-6)
    cfg = TransformerConfig(name="t", n_layers=1, d_model=64, n_heads=2,
                            n_kv_heads=2, d_ff=64, vocab_size=8,
                            attention="mla", kv_lora_rank=16,
                            rope_scaling=YARN)
    assert transformer._mla_scale(cfg) == pytest.approx(
        192 ** -0.5 * 1.5896261651, rel=1e-9)
    # the cos/sin magnitude is mscale / mscale_all_dim = 1 here; others scale
    x = torch.randn(3, 2, 64, generator=torch.Generator().manual_seed(10))
    pos = torch.arange(3)
    loud = dataclasses.replace(YARN, mscale=1.0)
    ratio = (yarn_mscale(40, 1.0) / yarn_mscale(40, 0.707))
    _close(apply_rope(x, pos, 1e4, loud), apply_rope(x, pos, 1e4, YARN) * ratio)


def _mla_moe_config(dtype="float32") -> TransformerConfig:
    return TransformerConfig(
        name="tiny-mla-moe", n_layers=3, d_model=D, n_heads=2, n_kv_heads=2,
        d_ff=64, vocab_size=20, attention="mla", kv_lora_rank=16,
        qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
        moe=MoEConfig(n_experts=E, top_k=K, d_expert=FE, n_shared=1,
                      d_shared=FE, first_dense_layers=1, d_ff_dense=64,
                      capacity_factor=None, norm_topk_prob=False),
        rope_scaling=YARN, norm_eps=1e-6, dtype=dtype, attn_chunk_q=8)


def test_a_request_alone_equals_it_in_a_batch_of_8():
    """Dropless routing: a request's prefill and decode logits do not
    depend on the requests served beside it (the capacity path's do)."""
    cfg = _mla_moe_config()
    params = transformer.init_params(cfg, seed=11, device="cpu")
    g = torch.Generator().manual_seed(12)
    tok = torch.randint(0, 20, (8, 12), generator=g)
    nxt = torch.randint(0, 20, (8, 2), generator=g)

    def run(cfg, rows):
        logits, cache = transformer.prefill(params, tok[rows], cfg, max_len=16)
        out = [logits]
        for t in range(2):
            logits, cache = transformer.decode_step(params, cache,
                                                    nxt[rows, t:t + 1], cfg)
            out.append(logits)
        return torch.cat(out, 1)

    alone, batch = run(cfg, slice(0, 1)), run(cfg, slice(0, 8))
    _close(batch[:1], alone)
    capped = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    assert float((run(capped, slice(0, 8))[:1]
                  - run(capped, slice(0, 1))).abs().max()) > 1e-3


@pytest.mark.parametrize("attention", ["gqa", "mla"])
def test_retriever_tiles_and_reorders_the_caches_own_arrays(attention,
                                                          monkeypatch):
    """The beams' cache is the prefill's arrays repeated over the beams
    (``repeat_interleave``) and each reorder an ``index_select`` of every
    array: ``k``/``v`` for a KV cache, ``c_kv``/``k_rope`` for MLA."""
    if attention == "mla":
        cfg, names = _mla_moe_config(), ("c_kv", "k_rope")
    else:
        cfg = TransformerConfig(name="tiny-gqa", n_layers=2, d_model=D,
                                n_heads=4, n_kv_heads=2, d_ff=64,
                                vocab_size=20, dtype="float32")
        names = ("k", "v")
    V, L, M, B = 16, 3, 4, 2
    params = transformer.init_params(cfg, seed=13, device="cpu")
    rng = np.random.default_rng(14)
    tm = TransitionMatrix.from_sids(rng.integers(0, V, (200, L)), V,
                                    dense_d=1, device="cpu")
    ret = GenerativeRetriever(params, cfg, DecodePolicy.static(tm), L, V,
                              beam_size=M)
    hist = torch.as_tensor(rng.integers(0, 20, (B, 6)))
    seen = {"gathers": 0}
    search = generative_retrieval.beam_search

    def spy(logits_fn, cache, *args, carry_gather_fn, **kw):
        seen["tiled"] = cache

        def gather(c, beam_idx):
            # checked now: the next decode step writes the arrays in place
            out = carry_gather_fn(c, beam_idx)
            flat = (torch.arange(B)[:, None] * M + beam_idx).reshape(-1)
            for n in names:
                assert torch.equal(getattr(out, n),
                                   getattr(c, n).index_select(1, flat))
            seen["gathers"] += 1
            return out

        return search(logits_fn, cache, *args, carry_gather_fn=gather, **kw)

    monkeypatch.setattr(generative_retrieval, "beam_search", spy)
    with torch.inference_mode():
        _, cache = transformer.prefill(params, hist, cfg, max_len=6 + L + 1)
        want = {n: getattr(cache, n).repeat_interleave(M, dim=1)
                for n in names}
        ret._retrieve(hist)
    assert isinstance(seen["tiled"], (kvcache.MLACache if attention == "mla"
                                      else kvcache.KVCache))
    assert seen["gathers"] == L - 1
    # the tiled arrays as the prefill left them, but for the decode slots
    S = hist.shape[1]
    for n in names:
        assert torch.equal(getattr(seen["tiled"], n)[:, :, :S],
                           want[n][:, :, :S])
