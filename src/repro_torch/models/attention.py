"""Attention: causal prefill attention and the single-token decode path.

Counterparts of ``repro.models.attention``, as plain torch ops with the
reference's ``(B, S, KVH, Dh)`` layout at the public functions.  GQA is a
``(KVH, G)`` factoring of the query heads, so the cache is never repeated
``G`` times.  As in the reference, both products are float32 results of the
operands' values (``preferred_element_type=float32`` there): the score
product is float32 before the scale and the softmax, the probabilities are
cast to the value dtype, the PV product is float32 again, and the output is
cast back to the query dtype at the end (``kernels/products.py``).  Decode
attention on a CUDA tensor is one hand-written kernel
(``kernels/decode_attention.py``) with the same arithmetic, reading the
cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.products import NEG, product_f32

__all__ = ["chunked_causal_attention", "decode_attention"]

def _chunk(size: int, total: int) -> int:
    """The reference's chunk: ``min(size, total)``, halved until it divides."""
    size = min(size, total)
    while total % size:
        size //= 2
    return size


def chunked_causal_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Skv, KVH, Dh)
    v: torch.Tensor,  # (B, Skv, KVH, Dv)
    *,
    chunk_q: int = 512,
    chunk_kv: int = 1024,
    window: int | None = None,
    q_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal attention in query chunks, streaming key chunks through the
    reference's online log-sum-exp (unnormalized probabilities cast to the
    value dtype, divided by their float32 sum at the end).

    Key chunks wholly after a query chunk, or wholly before the window of
    its first query, are skipped: masked for every query of the chunk, they
    would add exactly nothing (a leading all-masked chunk's terms are
    scaled by ``exp(NEG - m) = 0`` once a live key arrives).
    """
    B, Sq, H, Dh = q.shape
    Skv, KVH, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // KVH
    scale = scale if scale is not None else Dh ** -0.5
    cq, ck = _chunk(chunk_q, Sq), _chunk(chunk_kv, Skv)
    # (B*KVH, ...) operands of the batched products
    qg = q.reshape(B, Sq, KVH, G, Dh).permute(0, 2, 3, 1, 4)  # (B, KVH, G, Sq, Dh)
    kt = k.permute(0, 2, 3, 1).reshape(B * KVH, Dh, Skv)
    vv = v.permute(0, 2, 1, 3).reshape(B * KVH, Skv, Dv)
    outs = []
    for q0 in range(0, Sq, cq):
        q3 = qg[:, :, :, q0:q0 + cq].reshape(B * KVH, G * cq, Dh)
        q_pos = q_offset + torch.arange(q0, q0 + cq, device=q.device)
        m = torch.full((B * KVH, G, cq), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B * KVH, G * cq, Dv), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Skv, ck):
            if k0 > q_offset + q0 + cq - 1:
                break
            if window is not None and k0 + ck - 1 <= q_offset + q0 - window:
                continue
            s = product_f32(q3, kt[:, :, k0:k0 + ck]).view(
                B * KVH, G, cq, ck) * scale
            k_pos = torch.arange(k0, k0 + ck, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = product_f32(p.to(v.dtype).view(B * KVH, G * cq, ck),
                              vv[:, k0:k0 + ck])
            acc = acc * corr.view(B * KVH, G * cq, 1) + pv
            m = m_new
        o = acc / l.clamp_min(1e-30).view(B * KVH, G * cq, 1)
        outs.append(o.view(B, KVH, G, cq, Dv).permute(
            0, 3, 1, 2, 4).reshape(B, cq, H, Dv).to(q.dtype))
    return torch.cat(outs, dim=1)


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
    """Single-token GQA attention over a KV cache, slot-validity masked: the
    CUDA kernel on the card, its plain version (these products and softmax
    in torch ops, ``kernels/decode_attention.py``) elsewhere."""
    return ops.decode_attention(q, k_cache, v_cache, slot_positions, cur_pos,
                                window=window, scale=scale)
