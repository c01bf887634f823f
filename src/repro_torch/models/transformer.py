"""Decoder-only transformer family (``repro.models.transformer``).

One implementation, configured by :class:`TransformerConfig`:
  * GQA / MHA (optional QKV bias: the qwen1.5 family) — stablelm, qwen,
    codeqwen, static-gr;
  * sliding-window attention over a ring KV cache — mixtral;
  * MLA (multi-head latent attention, DeepSeek-V2) with the absorbed decode
    (scores and context in the latent space; the full K/V are never built
    at decode time) — deepseek-v2-lite;
  * MoE FFNs (:mod:`repro_torch.models.moe`): Mixtral 8 experts top-2;
    DeepSeek 64 top-6 + 2 shared, first layer dense.

Parameters are a plain dict mirroring the reference pytree, with the
stacked ``dense_layers`` and then ``moe_layers`` unstacked, in that order,
into one list of per-layer dicts (a Python loop takes the place of
``lax.scan``)::

    {"emb": (V, D), "final_norm": {"scale"}, ["unemb": (D, V)],
     "layers": [{"ln_attn": {"scale"},
                 "attn": GQA {"wq": {"w"[, "b"]}, "wk", "wv", "wo": {"w"}}
                         or MLA {"wq", "w_kv_a", "kv_norm", "w_kv_b", "wo"},
                 "ln_ffn": {"scale"},
                 "ffn": {"w1", "w3", "w2"} or "moe": {"router", "w1", ...}},
                ...]}

:func:`lm_loss` and :func:`lm_loss_trie_aware` are the training losses (the
layer body is recomputed in the backward when ``cfg.remat``, as the
reference's ``jax.checkpoint`` does; the MoE router's aux loss is added).
:func:`decode_step` under ``cfg.defer_cache_write`` leaves the cache arrays
unwritten and returns the step's per-layer k/v (or latents) for the caller
to commit.  ``cfg.decode_split_k`` only constrains JAX shardings in the
reference, so it changes nothing on one device and is not read here.
:func:`paged_decode_step` is the continuous engine's decode step over a
paged history (DESIGN.md §10); :func:`gr_decode_step` the prefix-shared
generative-retrieval step (one history cache per request, a short private
suffix per beam); both take dense GQA models only, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels.products import NEG, product_f32
from repro_torch.models import kvcache as kv_lib
from repro_torch.models.attention import (
    chunked_causal_attention,
    decode_attention,
)
from repro_torch.models.layers import (
    _generator,
    _he,
    apply_rope,
    dense_init,
    rms_norm,
    rms_norm_init,
    swiglu,
    swiglu_init,
    yarn_mscale,
)
from repro_torch.models.moe import moe_ffn, moe_init

__all__ = ["init_params", "param_specs", "forward", "lm_loss",
           "lm_loss_trie_aware", "init_cache", "prefill", "decode_step", "gr_decode_step",
           "paged_decode_step", "torch_dtype"]


def torch_dtype(cfg: TransformerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _dense_gqa_only(cfg: TransformerConfig, fn: str) -> None:
    """Raise where the reference's step only covers dense GQA models."""
    if (cfg.attention != "gqa" or cfg.sliding_window is not None
            or cfg.defer_cache_write or cfg.moe is not None):
        raise NotImplementedError(
            f"{fn} supports dense GQA models without sliding window / MLA / "
            "MoE / deferred writes")


# --------------------------------------------------------------------------
# Parameter initialization
# --------------------------------------------------------------------------


def _attn_init(gen, cfg: TransformerConfig, dtype, dev):
    D, H = cfg.d_model, cfg.n_heads
    if cfg.attention == "mla":
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        lora, vd = cfg.kv_lora_rank, cfg.v_head_dim
        return {
            "wq": _he(gen, (D, H * (nope + rope)), dtype, dev),
            "w_kv_a": _he(gen, (D, lora + rope), dtype, dev),
            "kv_norm": rms_norm_init(lora, dtype, dev),
            "w_kv_b": _he(gen, (lora, H * (nope + vd)), dtype, dev),
            "wo": _he(gen, (H * vd, D), dtype, dev, fan_in=H * vd),
        }
    hd, KV = cfg.resolved_head_dim(), cfg.n_kv_heads
    return {
        "wq": dense_init(gen, D, H * hd, dtype, cfg.qkv_bias, dev),
        "wk": dense_init(gen, D, KV * hd, dtype, cfg.qkv_bias, dev),
        "wv": dense_init(gen, D, KV * hd, dtype, cfg.qkv_bias, dev),
        "wo": {"w": _he(gen, (H * hd, D), dtype, dev, fan_in=H * hd)},
    }


def init_params(cfg: TransformerConfig, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``.

    Same distributions as the reference (normal * 0.02 embeddings, He-normal
    projections, unit norm scales, zero biases; the MoE weights as
    :func:`moe.moe_init` says); the numbers differ from ``jax.random``'s.
    Use :func:`repro_torch.convert.params_from_jax` to compute with the
    reference's weights.  On ``device="meta"`` no generator is made (there
    is none for meta) and the tree holds shapes and dtypes only
    (:func:`param_specs`).
    """
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = _generator(dev, seed)
    D = cfg.d_model
    emb = torch.randn((cfg.vocab_size, D), generator=gen, device=dev,
                      dtype=torch.float32)
    params = {"emb": (emb * 0.02).to(dtype),
              "final_norm": rms_norm_init(D, dtype, dev)}
    if not cfg.tie_embeddings:
        params["unemb"] = _he(gen, (D, cfg.vocab_size), dtype, dev)
    n_dense = cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers
    layers = []
    for i in range(cfg.n_layers):
        p = {"ln_attn": rms_norm_init(D, dtype, dev),
             "attn": _attn_init(gen, cfg, dtype, dev),
             "ln_ffn": rms_norm_init(D, dtype, dev)}
        if i >= n_dense:
            p["moe"] = moe_init(gen, D, cfg.moe, dtype, dev)
        else:
            d_ff = (cfg.moe.d_ff_dense if cfg.moe is not None
                    and cfg.moe.d_ff_dense else cfg.d_ff)
            p["ffn"] = swiglu_init(gen, D, d_ff, dtype, dev)
        layers.append(p)
    params["layers"] = layers
    return params


def param_specs(cfg: TransformerConfig):
    """:func:`init_params`' tree as ``meta`` tensors: its structure, shapes
    and dtypes, nothing allocated (the dry run's stand-ins)."""
    return init_params(cfg, device="meta")


def _proj(pp, x, width: int, hd: int):
    y = x @ pp["w"]
    if "b" in pp:
        y = y + pp["b"]
    return y.reshape(x.shape[:-1] + (width, hd))


def _unemb(params, cfg):
    return params["emb"].T if cfg.tie_embeddings else params["unemb"]


# --------------------------------------------------------------------------
# Full-sequence forward (training / prefill)
# --------------------------------------------------------------------------


def _mla_scale(cfg: TransformerConfig) -> float:
    """MLA's softmax scale: ``(nope + rope) ** -0.5``, times
    ``mscale(factor, mscale_all_dim) ** 2`` under YaRN (DeepSeek-V2)."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    ys = cfg.rope_scaling
    if ys is not None and ys.mscale_all_dim:
        scale *= yarn_mscale(ys.factor, ys.mscale_all_dim) ** 2
    return scale


def _attn_full(p, x, cfg: TransformerConfig):
    """Causal self-attention of x (B, S, D) -> (out (B, S, D), the layer's
    cache pair): ``(k, v)`` (B, S, KVH, Dh) for GQA, ``(c_kv (B, S, lora),
    k_rope (B, S, rope))`` for MLA, whose rotary key is shared by the
    heads and whose value width ``v_head_dim`` differs from the query's."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None]
    chunks = dict(chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
                  window=cfg.sliding_window)
    H = cfg.n_heads
    if cfg.attention == "mla":
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        lora, vd = cfg.kv_lora_rank, cfg.v_head_dim
        q = (x @ p["wq"]).reshape(B, S, H, nope + rope)
        kv_a = x @ p["w_kv_a"]  # (B, S, lora + rope)
        c_kv = rms_norm(p["kv_norm"], kv_a[..., :lora], cfg.norm_eps)
        q_rope = apply_rope(q[..., nope:], pos, cfg.rope_theta,
                            cfg.rope_scaling)
        k_rope = apply_rope(kv_a[..., lora:][:, :, None, :], pos,
                            cfg.rope_theta, cfg.rope_scaling)  # (B, S, 1, rope)
        kv_b = (c_kv @ p["w_kv_b"]).reshape(B, S, H, nope + vd)
        k = torch.cat([kv_b[..., :nope], k_rope.expand(B, S, H, rope)], -1)
        q = torch.cat([q[..., :nope], q_rope], dim=-1)
        out = chunked_causal_attention(q, k, kv_b[..., nope:],
                                       scale=_mla_scale(cfg), **chunks)
        return out.reshape(B, S, H * vd) @ p["wo"], (c_kv, k_rope[:, :, 0])
    hd, KV = cfg.resolved_head_dim(), cfg.n_kv_heads
    q = apply_rope(_proj(p["wq"], x, H, hd), pos, cfg.rope_theta)
    k = apply_rope(_proj(p["wk"], x, KV, hd), pos, cfg.rope_theta)
    v = _proj(p["wv"], x, KV, hd)
    out = chunked_causal_attention(q, k, v, **chunks)
    return out.reshape(B, S, H * hd) @ p["wo"]["w"], (k, v)


def _layer_fwd(p, x, cfg: TransformerConfig):
    """One layer: ``(x, cache pair, router aux loss)``."""
    attn_out, cache_kv = _attn_full(p["attn"], rms_norm(
        p["ln_attn"], x, cfg.norm_eps), cfg)
    x = x + attn_out
    h = rms_norm(p["ln_ffn"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_ffn(p["moe"], h, cfg.moe)
        return x + y, cache_kv, aux
    return (x + swiglu(p["ffn"], h), cache_kv,
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig,
            collect_cache: bool = False):
    """tokens (B, S) -> (hidden (B, S, D), per-layer cache stacks or None,
    the summed router aux loss (float32; 0 without MoE)).

    The stacks are the layers' cache pairs stacked on a leading layer axis
    when ``collect_cache``: ``(k, v)`` (n_layers, B, S, KVH, Dh), or for
    MLA ``(c_kv, k_rope)`` (n_layers, B, S, lora | rope).
    """
    # a gather whose CPU backward is deterministic (indexing's backward
    # adds rows from several threads, in an order that varies between runs)
    x = F.embedding(tokens.long(), params["emb"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # the reference's jax.checkpoint of the layer body: under autograd each
    # layer keeps only its input and recomputes the rest in the backward
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    firsts, seconds = [], []
    for p in params["layers"]:
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                lambda x, p=p: _layer_fwd(p, x, cfg)[::2], x,
                use_reentrant=False)
        else:
            x, (c1, c2), a = _layer_fwd(p, x, cfg)
            if collect_cache:
                firsts.append(c1)
                seconds.append(c2)
        aux = aux + a
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    stacks = ((torch.stack(firsts), torch.stack(seconds))
              if collect_cache else None)
    return x, stacks, aux


def _next_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """``torch.roll(tokens, -1, dims=1)`` as two slices: ``aten.roll`` has
    no DTensor sharding strategy in some torch releases (the dry run)."""
    return torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)


def lm_loss(params, tokens: torch.Tensor, cfg: TransformerConfig,
            ce_chunk: int | None = None) -> torch.Tensor:
    """Next-token CE, computed in sequence chunks (no (T, V) logits tensor
    is kept: each chunk's logits are recomputed in the backward, the
    reference's ``jax.checkpoint``), plus the MoE router's aux loss.

    The full sequence is forwarded and the final position is masked out of
    the loss, as in the reference.
    """
    x, _, aux = forward(params, tokens, cfg)
    labels = _next_tokens(tokens.long())
    B, S, D = x.shape
    valid = (torch.arange(S, device=x.device) < S - 1).float()
    w = _unemb(params, cfg)
    chunk = min(ce_chunk or cfg.ce_chunk, S)
    while S % chunk:
        chunk //= 2

    def body(xc, lc, vc):
        logits = (xc @ w).float()  # (B, chunk, V)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.sum((lse - ll) * vc)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        args = (x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                valid[c0:c0 + chunk])
        tot = tot + (torch.utils.checkpoint.checkpoint(
            body, *args, use_reentrant=False)
            if torch.is_grad_enabled() else body(*args))
    return tot / (B * (S - 1)) + aux


def lm_loss_trie_aware(params, tokens: torch.Tensor, cfg: TransformerConfig,
                       adm_mask: torch.Tensor, weight: float) -> torch.Tensor:
    """Next-token CE + the trie-aware admissible-mass auxiliary loss.

    ``adm_mask`` is (B, S, V) bool: the constrained decoder's admissible
    token set at the position of the token AT each index (the per-prefix
    sets of :mod:`repro_torch.scenarios.trie_signal`, gathered per item).
    The auxiliary term is ``logsumexp(logits) - logsumexp(logits[adm])``,
    i.e. -log P(admissible), averaged over the scored positions.  Dense
    (B, S, V) logits: this loss serves the small GR retrieval model.
    """
    x, _, aux = forward(params, tokens, cfg)
    labels = torch.roll(tokens.long(), -1, dims=1)
    # align masks with labels: position p scores the token at p+1
    mask = torch.roll(adm_mask, -1, dims=1)
    B, S, D = x.shape
    valid = (torch.arange(S, device=x.device) < S - 1).float()
    logits = (x @ _unemb(params, cfg)).float()  # (B, S, V)
    lse_full = torch.logsumexp(logits, dim=-1)
    # -1e30 (not -inf): an all-False row would otherwise give nan gradients
    lse_adm = torch.logsumexp(torch.where(mask, logits, -1e30), dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    denom = B * (S - 1)
    ce = torch.sum((lse_full - ll) * valid) / denom
    trie_aux = torch.sum((lse_full - lse_adm) * valid) / denom
    return ce + aux + weight * trie_aux


# --------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV caches
# --------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None):
    """An empty decode cache: MLA latents, or a KV cache that is a ring of
    ``sliding_window`` slots when the window is below ``max_len``."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    if cfg.attention == "mla":
        return kv_lib.init_mla_cache(
            cfg.n_layers, batch, max_len, cfg.kv_lora_rank,
            cfg.qk_rope_head_dim, dtype=dtype, device=dev)
    return kv_lib.init_kv_cache(
        cfg.n_layers, batch, max_len, cfg.n_kv_heads,
        cfg.resolved_head_dim(), dtype=dtype, device=dev,
        window=cfg.sliding_window)


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int | None = None):
    """Full-sequence pass that also builds the decode cache.

    Returns ``(last_token_logits (B, 1, V) f32, cache)``; ``max_len``
    reserves empty decode slots after the ``S`` prompt slots.  With a
    sliding window below ``max_len`` the cache is a ring of ``window``
    slots holding the last ``min(window, S)`` positions, each at slot
    ``pos % window``.
    """
    B, S = tokens.shape
    max_len = max(max_len or S, S)
    x, (c1, c2), _ = forward(params, tokens, cfg, collect_cache=True)
    logits = (x[:, -1:, :] @ _unemb(params, cfg)).float()
    dev = x.device
    window = cfg.sliding_window
    if cfg.attention != "mla" and window and window < max_len:
        keep = min(window, S)
        positions = torch.arange(S - keep, S, device=dev)
        slots = positions % window
        k = c1.new_zeros(c1.shape[:2] + (window,) + c1.shape[3:])
        v = c2.new_zeros(c2.shape[:2] + (window,) + c2.shape[3:])
        k[:, :, slots] = c1[:, :, S - keep:]
        v[:, :, slots] = c2[:, :, S - keep:]
        slot_pos = torch.full((window,), -1, dtype=torch.int32, device=dev)
        slot_pos[slots] = positions.int()
        return logits, kv_lib.KVCache(k=k, v=v, slot_pos=slot_pos, pos=S,
                                      ring=True)
    pad = max_len - S
    if pad:
        c1 = F.pad(c1, (0, 0) * (c1.dim() - 3) + (0, pad))
        c2 = F.pad(c2, (0, 0) * (c2.dim() - 3) + (0, pad))
    slot_pos = torch.full((max_len,), -1, dtype=torch.int32, device=dev)
    slot_pos[:S] = torch.arange(S, dtype=torch.int32, device=dev)
    if cfg.attention == "mla":
        return logits, kv_lib.MLACache(c_kv=c1, k_rope=c2,
                                       slot_pos=slot_pos, pos=S)
    return logits, kv_lib.KVCache(k=c1, v=c2, slot_pos=slot_pos, pos=S)


# --------------------------------------------------------------------------
# Single-token decode
# --------------------------------------------------------------------------


def _decode_attn_gqa(p, x, cfg, k_cache, v_cache, slot_pos, pos: int,
                     slot: int):
    """GQA attention of one token x (B, 1, D) over the layer's cache.

    Eager: this token's k/v are written at ``slot`` (in place) and attention
    runs over the cache.  Deferred (``cfg.defer_cache_write``): the cache
    is only read, over slots before ``pos``, and this token's score and
    value join in one softmax as a separate column, as in the reference;
    its k/v come back for the caller to commit.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    pos_t = torch.full((1, 1), pos, device=x.device)
    q = apply_rope(_proj(p["wq"], x, H, hd), pos_t, cfg.rope_theta)
    k_new = apply_rope(_proj(p["wk"], x, KV, hd), pos_t, cfg.rope_theta)
    v_new = _proj(p["wv"], x, KV, hd)
    window = cfg.sliding_window
    if not cfg.defer_cache_write:
        kv_lib.write_slot(k_cache, k_new, slot)
        kv_lib.write_slot(v_cache, v_new, slot)
        out = decode_attention(q, k_cache, v_cache, slot_pos, pos,
                               window=window)
        return out.reshape(B, 1, H * hd) @ p["wo"]["w"], (k_cache, v_cache)
    G, S = H // KV, k_cache.shape[1]
    scale = hd ** -0.5
    q3 = q.reshape(B * KV, G, hd)
    s_c = product_f32(q3, k_cache.permute(0, 2, 3, 1).reshape(
        B * KV, hd, S)).view(B, KV, G, S) * scale
    mask = (slot_pos >= 0) & (slot_pos < pos)
    if window is not None:
        mask = mask & (slot_pos > pos - window)
    s_c = torch.where(mask, s_c, NEG)
    s_n = product_f32(q3, k_new.reshape(B * KV, hd, 1)).view(
        B, KV, G, 1) * scale
    prob = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
    out_c = product_f32(
        prob[..., :-1].to(v_cache.dtype).reshape(B * KV, G, S),
        v_cache.permute(0, 2, 1, 3).reshape(B * KV, S, hd)).view(
        B, KV, G, hd)
    out_n = prob[..., -1:] * v_new.float().reshape(B, KV, 1, hd)
    out = (out_c + out_n).reshape(B, 1, H * hd).to(x.dtype)
    return out @ p["wo"]["w"], (k_new, v_new)


def _decode_attn_mla(p, x, cfg, c_cache, kr_cache, slot_pos, pos: int,
                     slot: int):
    """Absorbed MLA decode of one token x (B, 1, D): the query is folded
    through ``W_uk`` into the latent space, scores against the latents and
    the shared rotary keys are float32 products, and the float32 context
    over the latents is unfolded through ``W_uv``.  Eager and deferred as
    in :func:`_decode_attn_gqa`, over ``(c_kv, k_rope)``."""
    B = x.shape[0]
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    H, lora, vd = cfg.n_heads, cfg.kv_lora_rank, cfg.v_head_dim
    pos_t = torch.full((1, 1), pos, device=x.device)
    q = (x @ p["wq"]).reshape(B, 1, H, nope + rope)
    q_rope = apply_rope(q[..., nope:], pos_t, cfg.rope_theta,
                        cfg.rope_scaling)
    kv_a = x @ p["w_kv_a"]
    c_new = rms_norm(p["kv_norm"], kv_a[..., :lora],
                     cfg.norm_eps)  # (B, 1, lora)
    kr_new = apply_rope(kv_a[..., lora:], pos_t, cfg.rope_theta,
                        cfg.rope_scaling)
    defer = cfg.defer_cache_write
    if not defer:
        kv_lib.write_slot(c_cache, c_new, slot)
        kv_lib.write_slot(kr_cache, kr_new, slot)
    w_kv_b = p["w_kv_b"].view(lora, H, nope + vd)
    q_lat = torch.einsum("bqhn,lhn->bqhl", q[..., :nope],
                         w_kv_b[..., :nope]).reshape(B, H, lora)
    q_rope = q_rope.reshape(B, H, rope)
    scale = _mla_scale(cfg)
    s = (product_f32(q_lat, c_cache.transpose(1, 2))
         + product_f32(q_rope, kr_cache.transpose(1, 2))) * scale
    mask = (slot_pos >= 0) & ((slot_pos < pos) if defer else (slot_pos <= pos))
    s = torch.where(mask, s, NEG)  # (B, H, S)
    c = c_cache.float()
    if defer:
        s_n = (product_f32(q_lat, c_new.transpose(1, 2))
               + product_f32(q_rope, kr_new.transpose(1, 2))) * scale
        probs = torch.softmax(torch.cat([s, s_n], dim=-1), dim=-1)
        ctx = (torch.bmm(probs[..., :-1], c)
               + probs[..., -1:] * c_new.float())  # (B, H, lora)
    else:
        ctx = torch.bmm(torch.softmax(s, dim=-1), c)
    out = torch.einsum("bhl,lhv->bhv", ctx.to(x.dtype), w_kv_b[..., nope:])
    new = (c_new, kr_new) if defer else (c_cache, kr_cache)
    return out.reshape(B, 1, H * vd) @ p["wo"], new


def decode_step(params, cache, tokens: torch.Tensor, cfg: TransformerConfig):
    """One autoregressive step: tokens (B, 1) -> (logits (B, 1, V) f32,
    cache), or ``(logits, cache, pending)`` under ``cfg.defer_cache_write``.

    ``cache`` is a :class:`kvcache.KVCache` (a ring for sliding-window
    models) or, for MLA, a :class:`kvcache.MLACache`.  The write slot comes
    once from :func:`kvcache.advance_positions`; eager steps update the
    cache arrays in place and return them in a new cache object.  Deferred
    steps leave the arrays untouched (only ``slot_pos`` and ``pos``
    advance) and return ``pending``, the step's per-layer ``(k, v)``
    (n_layers, B, 1, KVH, Dh) or ``(c_kv, k_rope)`` (n_layers, B, 1, ...).
    """
    x = params["emb"][tokens.long()]  # (B, 1, D)
    pos = cache.pos
    mla = cfg.attention == "mla"
    arrays = (cache.c_kv, cache.k_rope) if mla else (cache.k, cache.v)
    ring = not mla and cache.ring
    slot_pos, slot = kv_lib.advance_positions(cache.slot_pos, pos,
                                              arrays[0].shape[2], ring)
    attend = _decode_attn_mla if mla else _decode_attn_gqa
    pending = ([], [])  # deferred writes: each layer's (k, v) or latents
    for i, p in enumerate(params["layers"]):
        h = rms_norm(p["ln_attn"], x, cfg.norm_eps)
        out, new = attend(p["attn"], h, cfg, arrays[0][i], arrays[1][i],
                          slot_pos, pos, slot)
        x = x + out
        h = rms_norm(p["ln_ffn"], x, cfg.norm_eps)
        x = x + (moe_ffn(p["moe"], h, cfg.moe, "decode")[0] if "moe" in p
                 else swiglu(p["ffn"], h))
        if cfg.defer_cache_write:
            pending[0].append(new[0])
            pending[1].append(new[1])
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = (x @ _unemb(params, cfg)).float()
    if mla:
        new_cache = kv_lib.MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope,
                                    slot_pos=slot_pos, pos=pos + 1)
    else:
        new_cache = kv_lib.KVCache(k=cache.k, v=cache.v, slot_pos=slot_pos,
                                   pos=pos + 1, ring=ring)
    if cfg.defer_cache_write:
        return logits, new_cache, (torch.stack(pending[0]),
                                   torch.stack(pending[1]))
    return logits, new_cache


def gr_decode_step(params, hist_k: torch.Tensor, hist_v: torch.Tensor,
                   beam_k: torch.Tensor, beam_v: torch.Tensor,
                   tokens: torch.Tensor, sid_step: int,
                   cfg: TransformerConfig):
    """Prefix-shared generative-retrieval decode (``gr_decode_step``).

    The history cache ``hist_k``/``hist_v`` (n_layers, B, S_h, KVH, Dh) is
    computed once per request and shared by its M beams; only the SID
    suffix ``beam_k``/``beam_v`` is private to a beam: (n_layers, B*M,
    S_sid, KVH, Dh), or (n_layers, B, M, S_sid, KVH, Dh) with
    ``cfg.gr_batched_beams`` (the same memory either way).  ``tokens``
    (B*M, 1) are the beams' last tokens at position ``S_h + sid_step``;
    their k/v land in suffix slot ``min(sid_step, S_sid - 1)``, in place.
    Attention runs over [history | suffix] with one softmax.

    As in the reference: both score products are float32 and scaled by
    ``hd**-0.5``, suffix slots past ``sid_step`` are set to -1e30, the
    probabilities are cast to the cache dtype before each value product
    (float32 results), and ``o1 + o2`` is cast once.  GQA is a grouped
    view, queries ``(.., KVH, G, Dh)`` against the unrepeated cache: the
    history is laid out once per request and layer (B rows, not B*M) and
    never repeated over the groups.

    Returns ``(logits (B*M, 1, vocab) f32, beam_k, beam_v)``.
    """
    _dense_gqa_only(cfg, "gr_decode_step")
    BM = tokens.shape[0]
    B, S_h = hist_k.shape[1], hist_k.shape[2]
    M = BM // B
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    batched = cfg.gr_batched_beams
    S_sid = beam_k.shape[3] if batched else beam_k.shape[2]
    sid_step = int(sid_step)
    pos = S_h + sid_step
    slot = min(sid_step, S_sid - 1)
    scale = hd ** -0.5
    x = params["emb"][tokens.long()]  # (BM, 1, D)
    dev = x.device
    pos_t = torch.full((1, 1), pos, device=dev)
    sid_mask = torch.arange(S_sid, device=dev) <= sid_step
    for i, p in enumerate(params["layers"]):
        h = rms_norm(p["ln_attn"], x, cfg.norm_eps)
        a = p["attn"]
        q = apply_rope(_proj(a["wq"], h, H, hd), pos_t, cfg.rope_theta)
        k_new = apply_rope(_proj(a["wk"], h, KV, hd), pos_t, cfg.rope_theta)
        v_new = _proj(a["wv"], h, KV, hd)
        # both layouts are one (B, M, S_sid, KV, hd) view of the same memory
        bk = beam_k[i].view(B, M, S_sid, KV, hd)
        bv = beam_v[i].view(B, M, S_sid, KV, hd)
        bk[:, :, slot] = k_new.reshape(B, M, KV, hd).to(bk.dtype)
        bv[:, :, slot] = v_new.reshape(B, M, KV, hd).to(bv.dtype)
        hk, hv = hist_k[i], hist_v[i]  # (B, S_h, KV, hd)
        qg = q.reshape(B, M, KV, G, hd)
        # history: per (request, kv head) one (M*G, hd) x (hd, S_h) product
        q1 = qg.permute(0, 2, 1, 3, 4).reshape(B * KV, M * G, hd)
        s1 = product_f32(q1, hk.permute(0, 2, 3, 1).reshape(
            B * KV, hd, S_h)).view(B, KV, M, G, S_h) * scale
        # suffix: per (beam, kv head) one (G, hd) x (hd, S_sid) product
        s2 = product_f32(qg.reshape(BM * KV, G, hd), bk.permute(
            0, 1, 3, 4, 2).reshape(BM * KV, hd, S_sid)).view(
            B, M, KV, G, S_sid) * scale
        s2 = torch.where(sid_mask, s2, NEG)
        s = torch.cat([s1.permute(0, 2, 1, 3, 4), s2], dim=-1)
        prob = torch.softmax(s, dim=-1)  # (B, M, KV, G, S_h + S_sid)
        p1 = prob[..., :S_h].to(hv.dtype).permute(0, 2, 1, 3, 4).reshape(
            B * KV, M * G, S_h)
        o1 = product_f32(p1, hv.permute(0, 2, 1, 3).reshape(
            B * KV, S_h, hd)).view(B, KV, M, G, hd).permute(0, 2, 1, 3, 4)
        p2 = prob[..., S_h:].to(bv.dtype).reshape(BM * KV, G, S_sid)
        o2 = product_f32(p2, bv.permute(0, 1, 3, 2, 4).reshape(
            BM * KV, S_sid, hd)).view(B, M, KV, G, hd)
        out = (o1 + o2).reshape(BM, 1, H * hd).to(x.dtype)
        x = x + out @ a["wo"]["w"]
        x = x + swiglu(p["ffn"], rms_norm(p["ln_ffn"], x, cfg.norm_eps))
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = (x @ _unemb(params, cfg)).float()
    return logits, beam_k, beam_v


def paged_decode_step(params, k_pool: torch.Tensor, v_pool: torch.Tensor,
                      page_table: torch.Tensor, suffix_k: torch.Tensor,
                      suffix_v: torch.Tensor, tokens: torch.Tensor,
                      pos: torch.Tensor, write_col: torch.Tensor,
                      cfg: TransformerConfig, *, hist_len: int):
    """One continuous-batching decode step through the paged KV cache.

    ``k_pool``/``v_pool`` (n_layers, P, page_size, KVH, Dh) hold the shared
    histories, read through ``page_table`` (slots, n_pages); the per-beam
    decoded suffixes ``suffix_k``/``suffix_v`` (n_layers, slots, M, Ls, KVH,
    Dh) are written in place.  ``tokens`` (slots, M) are each beam's last
    emitted token, ``pos`` (slots,) each slot's attention position
    (``S + level - 1``) and ``write_col`` (slots,) the suffix column that
    receives this step's k/v.  Rows may sit at different decode levels:
    attention masks each row to its own ``[0, pos]`` window.

    Bit-identity contract (DESIGN.md §10): a row at level ``l >= 1`` with
    ``pos = S + l - 1`` computes what the ``l``-th sequential
    :func:`decode_step` computes for it, op for op: the gathered history
    is sliced to exactly ``hist_len`` columns and followed by the
    ``Ls = L + 1`` suffix columns, so the attention width ``S + L + 1`` is
    the retriever's cache width and every reduction keeps its shape (the
    matrix products' shapes too, when ``slots * M`` equals the batch
    engine's row count).  Rows whose output is unused (level 0, dead
    slots) must point ``write_col`` at the trash column ``Ls - 1``, which
    no in-range ``pos`` attends to.

    Returns ``(logits (slots*M, 1, vocab) f32, suffix_k, suffix_v)``.
    """
    if cfg.decode_split_k:
        raise NotImplementedError("paged_decode_step takes no split-K decode")
    _dense_gqa_only(cfg, "paged_decode_step")
    slots, M = tokens.shape
    N, S, Ls = slots * M, int(hist_len), suffix_k.shape[3]
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if page_table.shape[1] * k_pool.shape[2] < S:
        raise ValueError(f"page table covers {page_table.shape[1]} pages of "
                         f"{k_pool.shape[2]} columns < hist_len {S}")
    dev = tokens.device
    x = params["emb"][tokens.reshape(N, 1).long()]  # (N, 1, D)
    pos_row = pos.long().repeat_interleave(M)  # (N,)
    # synthetic slot positions: history columns 0..S-1, then the suffix at
    # S..S+Ls-1; equal to the sequential cache's slot positions at every
    # column <= pos, and the trash column S+Ls-1 > pos is always masked
    slot_positions = torch.arange(S + Ls, dtype=torch.int32, device=dev)
    slot_ix = torch.arange(slots, device=dev)[:, None]
    beam_ix = torch.arange(M, device=dev)[None, :]
    col_ix = write_col.long()[:, None].expand(slots, M)
    for i, p in enumerate(params["layers"]):
        h = rms_norm(p["ln_attn"], x, cfg.norm_eps)
        a = p["attn"]
        q = apply_rope(_proj(a["wq"], h, H, hd), pos_row[:, None],
                       cfg.rope_theta)
        k_new = apply_rope(_proj(a["wk"], h, KV, hd), pos_row[:, None],
                           cfg.rope_theta)
        v_new = _proj(a["wv"], h, KV, hd)
        # this step's k/v into the per-beam suffix BEFORE attention
        # (decode_step's order), at each slot's own column
        sk, sv = suffix_k[i], suffix_v[i]
        sk[slot_ix, beam_ix, col_ix] = k_new.reshape(slots, M, KV, hd).to(
            sk.dtype)
        sv[slot_ix, beam_ix, col_ix] = v_new.reshape(slots, M, KV, hd).to(
            sv.dtype)
        # [history | suffix] as one (N, S + Ls, KV, hd) operand, the shape
        # of the retriever's cache: decode_attention reduces over it whole.
        # Writing the history into it fans it out over the M beams, a real
        # copy (the reference's jnp.repeat), and the only one.
        kc = _history_and_suffix(k_pool[i], page_table, sk, S, M)
        vc = _history_and_suffix(v_pool[i], page_table, sv, S, M)
        out = decode_attention(q, kc, vc, slot_positions, pos_row)
        x = x + out.reshape(N, 1, H * hd) @ a["wo"]["w"]
        x = x + swiglu(p["ffn"], rms_norm(p["ln_ffn"], x, cfg.norm_eps))
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = (x @ _unemb(params, cfg)).float()
    return logits, suffix_k, suffix_v


def _history_and_suffix(pool_layer, page_table, suffix, S: int, M: int):
    """(slots*M, S + Ls, KV, hd): each slot's paged history, repeated for
    its M beams, then each beam's suffix (in the pool's dtype)."""
    slots, Ls = suffix.shape[0], suffix.shape[2]
    hist = kv_lib.gather_pages(pool_layer, page_table, S)
    out = torch.empty((slots, M, S + Ls) + tuple(hist.shape[2:]),
                      dtype=hist.dtype, device=hist.device)
    out[:, :, :S] = hist[:, None]
    out[:, :, S:] = suffix
    return out.reshape((slots * M, S + Ls) + tuple(hist.shape[2:]))
