"""Attention: causal prefill attention and the single-token decode path.

Counterparts of ``repro.models.attention``, as plain torch ops with the
reference's ``(B, S, KVH, Dh)`` layout at the public functions.  GQA is a
``(KVH, G)`` factoring of the query heads, so the cache is never repeated
``G`` times.  Scores and softmax run in float32; the products themselves
run in the inputs' dtype (cuBLAS accumulates bf16 in float32 and rounds the
product to bf16, where the TPU reference asks XLA for float32 products).
"""
from __future__ import annotations

import torch

__all__ = ["chunked_causal_attention", "decode_attention"]

NEG = -1.0e30


def chunked_causal_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Skv, KVH, Dh)
    v: torch.Tensor,  # (B, Skv, KVH, Dv)
    *,
    chunk_q: int = 512,
    window: int | None = None,
    q_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal attention in query chunks of ``chunk_q`` rows.

    Each chunk takes an exact softmax over all keys, so memory is
    ``O(B * H * chunk_q * Skv)``; the reference's online-softmax streaming
    over key chunks gives the same values up to rounding.
    """
    B, Sq, H, Dh = q.shape
    Skv, KVH, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // KVH
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.reshape(B, Sq, KVH, G, Dh)
    k_pos = torch.arange(Skv, device=q.device)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, chunk_q):
        q1 = min(q0 + chunk_q, Sq)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, q0:q1], k).float() * scale
        q_pos = q_offset + torch.arange(q0, q1, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
        out[:, q0:q1] = o.reshape(B, q1 - q0, H, Dv)
    return out


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, S, KVH, Dh)
    v_cache: torch.Tensor,  # (B, S, KVH, Dv)
    slot_positions: torch.Tensor,  # (S,) or (B, S): position per slot, -1 empty
    cur_pos,  # int or (B,) tensor: position of the query token
    *,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token GQA attention over a KV cache, slot-validity masked."""
    B, S, KVH, Dh = k_cache.shape
    H = q.shape[2]
    Dv = v_cache.shape[-1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qg = q.reshape(B, KVH, H // KVH, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    pos = slot_positions.expand(B, S)
    cur = torch.as_tensor(cur_pos, device=q.device).expand(B)[:, None]
    mask = (pos >= 0) & (pos <= cur)
    if window is not None:
        mask = mask & (pos > cur - window)
    s = torch.where(mask[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, Dv).to(q.dtype)
