"""Foundational layers: initializers, RMSNorm, RoPE, SwiGLU, MLPs
(``repro.models.layers``).

Parameters are plain dicts of tensors, as in the reference.  Initializers
take an explicit ``torch.Generator`` and device (the numbers differ from
``jax.random``'s; the distributions are the same).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "dense", "mlp_init", "mlp", "rms_norm_init",
           "rms_norm", "swiglu_init", "swiglu", "rope_frequencies",
           "yarn_mscale", "yarn_correction_range", "yarn_frequencies",
           "apply_rope"]


def _generator(dev: torch.device, seed: int):
    """A seeded generator on ``dev``; ``None`` on ``meta``, which has no
    generator and whose factories draw nothing."""
    return (None if dev.type == "meta"
            else torch.Generator(device=dev).manual_seed(seed))


def _he(gen: torch.Generator, shape, dtype, device, fan_in=None):
    """He-normal: normal * sqrt(2 / fan_in), fan_in the leading dim."""
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * (2.0 / fan_in) ** 0.5).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, bias: bool = False, device=None):
    p = {"w": _he(gen, (d_in, d_out), dtype, device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_init(gen: torch.Generator, dims, dtype=torch.bfloat16,
             bias: bool = True, device=None):
    """dims = (d_in, h1, ..., d_out); ReLU between layers."""
    return {f"l{i}": dense_init(gen, dims[i], dims[i + 1], dtype, bias=bias,
                                device=device)
            for i in range(len(dims) - 1)}


def mlp(p, x: torch.Tensor, act=F.relu) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x)
        if i < n - 1:
            x = act(x)
    return x


def rms_norm_init(d: int, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.bfloat16, device=None):
    return {"w1": _he(gen, (d_model, d_ff), dtype, device),
            "w3": _he(gen, (d_model, d_ff), dtype, device),
            "w2": _he(gen, (d_ff, d_model), dtype, device)}


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude factor ``0.1 * mscale * ln(factor) + 1`` (1 for a
    factor of at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(dim: int, theta: float, scaling) -> tuple:
    """The pairs ``[low, high]`` over which YaRN ramps from the original
    frequencies (below ``low``) to those divided by the factor (from
    ``high``): the pairs making ``beta_fast`` and ``beta_slow`` rotations
    over ``original_max_position_embeddings`` positions."""
    def pair(rotations):
        return (dim * math.log(scaling.original_max_position_embeddings
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    return (max(math.floor(pair(scaling.beta_fast)), 0),
            min(math.ceil(pair(scaling.beta_slow)), dim - 1))


def yarn_frequencies(dim: int, theta: float, scaling,
                     device=None) -> torch.Tensor:
    """DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` frequencies: each
    pair's original frequency blended with it divided by ``factor``,
    weighted by a ramp over :func:`yarn_correction_range`."""
    extra = rope_frequencies(dim, theta, device)
    low, high = yarn_correction_range(dim, theta, scaling)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return extra / scaling.factor * ramp + extra * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0, scaling=None) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions broadcastable to (..., S).

    Rotates *interleaved* pairs ``(x[..., 0::2], x[..., 1::2])``, exactly as
    the reference does (not the half-split layout).  With ``scaling`` (a
    :class:`~repro_torch.configs.base.RopeScaling`) the frequencies are
    YaRN's and cos and sin carry ``mscale(factor, mscale) /
    mscale(factor, mscale_all_dim)``, as DeepSeek-V2's cache does.
    """
    dh = x.shape[-1]
    if scaling is None:
        freqs, mag = rope_frequencies(dh, theta, device=x.device), 1.0
    else:
        freqs = yarn_frequencies(dh, theta, scaling, device=x.device)
        mag = (yarn_mscale(scaling.factor, scaling.mscale)
               / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
    angles = positions[..., None].float() * freqs  # (..., S, Dh/2)
    if x.dim() == angles.dim() + 1:  # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if mag != 1.0:
        cos, sin = cos * mag, sin * mag
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
