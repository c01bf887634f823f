"""Decoder-only GQA transformer (``repro.models.transformer``, GQA path).

Parameters are a plain dict mirroring the reference pytree, with the
stacked ``dense_layers`` unstacked into a list of per-layer dicts (a Python
loop takes the place of ``lax.scan``)::

    {"emb": (V, D), "final_norm": {"scale"}, ["unemb": (D, V)],
     "layers": [{"ln_attn": {"scale"},
                 "attn": {"wq": {"w"[, "b"]}, "wk": ..., "wv": ..., "wo": {"w"}},
                 "ln_ffn": {"scale"},
                 "ffn": {"w1", "w3", "w2"}}, ...]}

MLA, MoE, sliding-window attention, deferred cache writes and the paged
decode step are not ported yet; configs asking for them raise.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import TransformerConfig
from repro_torch.models import kvcache as kv_lib
from repro_torch.models.attention import chunked_causal_attention, decode_attention
from repro_torch.models.layers import apply_rope, rms_norm, swiglu

__all__ = ["init_params", "forward", "prefill", "decode_step", "torch_dtype"]


def torch_dtype(cfg: TransformerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: TransformerConfig) -> None:
    """Raise on the config paths this port does not implement yet."""
    missing = [name for name, on in (
        ("MLA attention", cfg.attention != "gqa"),
        ("MoE FFNs", cfg.moe is not None),
        ("sliding-window attention", cfg.sliding_window is not None),
        ("deferred cache writes", cfg.defer_cache_write),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch yet")


# --------------------------------------------------------------------------
# Parameter initialization
# --------------------------------------------------------------------------


def init_params(cfg: TransformerConfig, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``.

    Same distributions as the reference (normal * 0.02 embeddings, He-normal
    projections, unit norm scales, zero biases); the numbers differ from
    ``jax.random``'s.  Use :func:`repro_torch.convert.params_from_jax` to
    compute with the reference's weights.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, hd = cfg.d_model, cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * std).to(dtype)

    def he(d_in, d_out, fan_in=None):
        return normal((d_in, d_out), (2.0 / (fan_in or d_in)) ** 0.5)

    def ones(d):
        return {"scale": torch.ones(d, dtype=dtype, device=dev)}

    def dense(d_in, d_out):
        p = {"w": he(d_in, d_out)}
        if cfg.qkv_bias:
            p["b"] = torch.zeros(d_out, dtype=dtype, device=dev)
        return p

    params = {"emb": normal((cfg.vocab_size, D), 0.02), "final_norm": ones(D)}
    if not cfg.tie_embeddings:
        params["unemb"] = he(D, cfg.vocab_size)
    params["layers"] = [
        {
            "ln_attn": ones(D),
            "attn": {"wq": dense(D, H * hd), "wk": dense(D, KV * hd),
                     "wv": dense(D, KV * hd),
                     "wo": {"w": he(H * hd, D, fan_in=H * hd)}},
            "ln_ffn": ones(D),
            "ffn": {"w1": he(D, cfg.d_ff), "w3": he(D, cfg.d_ff),
                    "w2": he(cfg.d_ff, D)},
        }
        for _ in range(cfg.n_layers)
    ]
    return params


def _proj(pp, x, width: int, hd: int):
    y = x @ pp["w"]
    if "b" in pp:
        y = y + pp["b"]
    return y.reshape(x.shape[:-1] + (width, hd))


def _unemb(params, cfg):
    return params["emb"].T if cfg.tie_embeddings else params["unemb"]


# --------------------------------------------------------------------------
# Full-sequence forward (prefill)
# --------------------------------------------------------------------------


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig,
            collect_cache: bool = False):
    """tokens (B, S) -> (hidden (B, S, D), per-layer (k, v) stacks or None).

    The stacks are ``(n_layers, B, S, KVH, Dh)`` each when ``collect_cache``.
    """
    check_supported(cfg)
    B, S = tokens.shape
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    x = params["emb"][tokens.long()]
    pos = torch.arange(S, device=x.device)[None]
    ks, vs = [], []
    for p in params["layers"]:
        h = rms_norm(p["ln_attn"], x, cfg.norm_eps)
        a = p["attn"]
        q = apply_rope(_proj(a["wq"], h, H, hd), pos, cfg.rope_theta)
        k = apply_rope(_proj(a["wk"], h, KV, hd), pos, cfg.rope_theta)
        v = _proj(a["wv"], h, KV, hd)
        out = chunked_causal_attention(q, k, v, chunk_q=cfg.attn_chunk_q,
                                       chunk_kv=cfg.attn_chunk_kv)
        x = x + out.reshape(B, S, H * hd) @ a["wo"]["w"]
        x = x + swiglu(p["ffn"], rms_norm(p["ln_ffn"], x, cfg.norm_eps))
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_cache else None)


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int | None = None):
    """Full-sequence pass that also builds the decode cache.

    Returns ``(last_token_logits (B, 1, V) f32, cache)``; ``max_len``
    reserves empty decode slots after the ``S`` prompt slots.
    """
    B, S = tokens.shape
    max_len = max(max_len or S, S)
    x, (ks, vs) = forward(params, tokens, cfg, collect_cache=True)
    logits = (x[:, -1:, :] @ _unemb(params, cfg)).float()
    pad = max_len - S
    if pad:
        ks = torch.nn.functional.pad(ks, (0, 0, 0, 0, 0, pad))
        vs = torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, pad))
    slot_pos = torch.full((max_len,), -1, dtype=torch.int32, device=x.device)
    slot_pos[:S] = torch.arange(S, dtype=torch.int32, device=x.device)
    return logits, kv_lib.KVCache(k=ks, v=vs, slot_pos=slot_pos, pos=S)


# --------------------------------------------------------------------------
# Single-token decode
# --------------------------------------------------------------------------


def decode_step(params, cache: kv_lib.KVCache, tokens: torch.Tensor,
                cfg: TransformerConfig):
    """One autoregressive step: tokens (B, 1) -> (logits (B, 1, V) f32, cache).

    The write slot comes once from :func:`kvcache.advance_positions`; the
    cache arrays are updated in place and returned in a new ``KVCache``.
    """
    check_supported(cfg)
    B = tokens.shape[0]
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    x = params["emb"][tokens.long()]  # (B, 1, D)
    pos = cache.pos
    slot_pos, slot = kv_lib.advance_positions(cache.slot_pos, pos,
                                              cache.k.shape[2])
    pos_t = torch.full((1, 1), pos, device=x.device)
    for i, p in enumerate(params["layers"]):
        h = rms_norm(p["ln_attn"], x, cfg.norm_eps)
        a = p["attn"]
        q = apply_rope(_proj(a["wq"], h, H, hd), pos_t, cfg.rope_theta)
        k_new = apply_rope(_proj(a["wk"], h, KV, hd), pos_t, cfg.rope_theta)
        v_new = _proj(a["wv"], h, KV, hd)
        k_cache = kv_lib.write_slot(cache.k[i], k_new, slot)
        v_cache = kv_lib.write_slot(cache.v[i], v_new, slot)
        out = decode_attention(q, k_cache, v_cache, slot_pos, pos)
        x = x + out.reshape(B, 1, H * hd) @ a["wo"]["w"]
        x = x + swiglu(p["ffn"], rms_norm(p["ln_ffn"], x, cfg.norm_eps))
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = (x @ _unemb(params, cfg)).float()
    return logits, kv_lib.KVCache(k=cache.k, v=cache.v, slot_pos=slot_pos,
                                  pos=pos + 1)
