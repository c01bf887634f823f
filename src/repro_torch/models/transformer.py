"""Decoder-only GQA transformer (``repro.models.transformer``, GQA path).

Parameters are a plain dict mirroring the reference pytree, with the
stacked ``dense_layers`` unstacked into a list of per-layer dicts (a Python
loop takes the place of ``lax.scan``)::

    {"emb": (V, D), "final_norm": {"scale"}, ["unemb": (D, V)],
     "layers": [{"ln_attn": {"scale"},
                 "attn": {"wq": {"w"[, "b"]}, "wk": ..., "wv": ..., "wo": {"w"}},
                 "ln_ffn": {"scale"},
                 "ffn": {"w1", "w3", "w2"}}, ...]}

MLA, MoE, sliding-window attention and deferred cache writes are not
ported yet; configs asking for them raise.  :func:`lm_loss` and
:func:`lm_loss_trie_aware` are the training losses (the layer body is
recomputed in the backward when ``cfg.remat``, as the reference's
``jax.checkpoint`` does).  :func:`paged_decode_step` is the
continuous engine's decode step over a paged history (DESIGN.md §10);
:func:`gr_decode_step` the prefix-shared generative-retrieval step (one
history cache per request, a short private suffix per beam).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import TransformerConfig
from repro_torch.models import kvcache as kv_lib
from repro_torch.models.attention import (
    NEG,
    _product_f32,
    chunked_causal_attention,
    decode_attention,
)
from repro_torch.models.layers import apply_rope, rms_norm, swiglu

__all__ = ["init_params", "forward", "lm_loss", "lm_loss_trie_aware",
           "prefill", "decode_step",
           "gr_decode_step", "paged_decode_step", "torch_dtype"]


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
# Full-sequence forward (training / prefill)
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
    # a gather whose CPU backward is deterministic (indexing's backward
    # adds rows from several threads, in an order that varies between runs)
    x = torch.nn.functional.embedding(tokens.long(), params["emb"])
    pos = torch.arange(S, device=x.device)[None]

    def layer(x, p):
        h = rms_norm(p["ln_attn"], x, cfg.norm_eps)
        a = p["attn"]
        q = apply_rope(_proj(a["wq"], h, H, hd), pos, cfg.rope_theta)
        k = apply_rope(_proj(a["wk"], h, KV, hd), pos, cfg.rope_theta)
        v = _proj(a["wv"], h, KV, hd)
        out = chunked_causal_attention(q, k, v, chunk_q=cfg.attn_chunk_q,
                                       chunk_kv=cfg.attn_chunk_kv)
        x = x + out.reshape(B, S, H * hd) @ a["wo"]["w"]
        x = x + swiglu(p["ffn"], rms_norm(p["ln_ffn"], x, cfg.norm_eps))
        return x, k, v

    # the reference's jax.checkpoint of the layer body: under autograd each
    # layer keeps only its input and recomputes the rest in the backward
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    ks, vs = [], []
    for p in params["layers"]:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda x, p=p: layer(x, p)[0], x, use_reentrant=False)
            continue
        x, k, v = layer(x, p)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_cache else None)


def lm_loss(params, tokens: torch.Tensor, cfg: TransformerConfig,
            ce_chunk: int | None = None) -> torch.Tensor:
    """Next-token CE, computed in sequence chunks (no (T, V) logits tensor
    is kept: each chunk's logits are recomputed in the backward, the
    reference's ``jax.checkpoint``).

    The full sequence is forwarded and the final position is masked out of
    the loss, as in the reference.  The MoE auxiliary loss is 0: the port
    has no MoE (``check_supported``).
    """
    x, _ = forward(params, tokens, cfg)
    labels = torch.roll(tokens.long(), -1, dims=1)
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
    return tot / (B * (S - 1))


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
    x, _ = forward(params, tokens, cfg)
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
    return ce + weight * trie_aux


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
    check_supported(cfg)
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
        s1 = _product_f32(q1, hk.permute(0, 2, 3, 1).reshape(
            B * KV, hd, S_h)).view(B, KV, M, G, S_h) * scale
        # suffix: per (beam, kv head) one (G, hd) x (hd, S_sid) product
        s2 = _product_f32(qg.reshape(BM * KV, G, hd), bk.permute(
            0, 1, 3, 4, 2).reshape(BM * KV, hd, S_sid)).view(
            B, M, KV, G, S_sid) * scale
        s2 = torch.where(sid_mask, s2, NEG)
        s = torch.cat([s1.permute(0, 2, 1, 3, 4), s2], dim=-1)
        prob = torch.softmax(s, dim=-1)  # (B, M, KV, G, S_h + S_sid)
        p1 = prob[..., :S_h].to(hv.dtype).permute(0, 2, 1, 3, 4).reshape(
            B * KV, M * G, S_h)
        o1 = _product_f32(p1, hv.permute(0, 2, 1, 3).reshape(
            B * KV, S_h, hd)).view(B, KV, M, G, hd).permute(0, 2, 1, 3, 4)
        p2 = prob[..., S_h:].to(bv.dtype).reshape(BM * KV, G, S_sid)
        o2 = _product_f32(p2, bv.permute(0, 1, 3, 2, 4).reshape(
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
    if (cfg.attention != "gqa" or cfg.sliding_window is not None
            or cfg.defer_cache_write or cfg.moe is not None
            or cfg.decode_split_k):
        raise NotImplementedError(
            "paged_decode_step supports dense GQA models without sliding "
            "window / MLA / MoE / deferred writes / split-K decode")
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
