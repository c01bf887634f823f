"""Foundational layers: RMSNorm, RoPE, SwiGLU (``repro.models.layers``).

Parameters are plain dicts of tensors, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "swiglu", "rope_frequencies", "apply_rope"]


def rms_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions broadcastable to (..., S).

    Rotates *interleaved* pairs ``(x[..., 0::2], x[..., 1::2])``, exactly as
    the reference does (not the half-split layout).
    """
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, Dh/2)
    if x.dim() == angles.dim() + 1:  # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
