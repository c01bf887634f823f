"""RQ-VAE Semantic-ID tokenizer (paper §3.1, following TIGER
arXiv:2305.05065; ``repro.models.rqvae``).

Item features are encoded to a latent, then residual-quantized across L
level-specific codebooks; the codeword indices (y_1..y_L) are the Semantic
ID.  Training uses straight-through estimation with reconstruction +
commitment losses.  Parameters are a plain dict of float32 tensors::

    {"encoder": {"l0": {"w", "b"}, ...}, "decoder": {...},
     "codebooks": (n_levels, codebook_size, latent_dim)}
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RQVAEConfig
from repro_torch.models.layers import mlp, mlp_init

__all__ = ["init_params", "rqvae_loss", "encode_to_sids", "decode_from_sids",
           "assign_dedup_tokens"]


def init_params(cfg: RQVAEConfig, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (CUDA unless the caller names one): He-normal MLPs with zero biases,
    codebooks normal * 0.5, as the reference draws them (the numbers differ
    from ``jax.random``'s; :func:`repro_torch.convert.rqvae_params_from_jax`
    carries the reference's over)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc_dims = (cfg.feat_dim,) + tuple(cfg.enc_hidden) + (cfg.latent_dim,)
    dec_dims = ((cfg.latent_dim,) + tuple(reversed(cfg.enc_hidden))
                + (cfg.feat_dim,))
    return {
        "encoder": mlp_init(gen, enc_dims, torch.float32, device=dev),
        "decoder": mlp_init(gen, dec_dims, torch.float32, device=dev),
        "codebooks": torch.randn(
            (cfg.n_levels, cfg.codebook_size, cfg.latent_dim), generator=gen,
            device=dev) * 0.5,
    }


def _quantize(residual: torch.Tensor, codebook: torch.Tensor):
    """Nearest codeword: residual (B, Z), codebook (V, Z) -> (idx (B,),
    codewords (B, Z)); the lowest index wins a tie, as ``jnp.argmin``."""
    d = (torch.sum(residual ** 2, -1, keepdim=True)
         - 2.0 * residual @ codebook.T
         + torch.sum(codebook ** 2, -1)[None, :])
    idx = torch.argmin(d, dim=-1)
    return idx, codebook[idx]


def _residual_quantize(params, z: torch.Tensor):
    r, q_sum, idx = z, torch.zeros_like(z), []
    for codebook in params["codebooks"]:
        i, q = _quantize(r, codebook)
        r, q_sum = r - q, q_sum + q
        idx.append(i)
    return torch.stack(idx, dim=1), q_sum, r  # (B, L), (B, Z), residual


def rqvae_loss(params, feats: torch.Tensor, cfg: RQVAEConfig) -> torch.Tensor:
    z = mlp(params["encoder"], feats)
    _, q, _ = _residual_quantize(params, z)
    # straight-through: the decoder sees z + sg(q - z)
    z_q = z + (q - z).detach()
    recon = mlp(params["decoder"], z_q)
    recon_loss = torch.mean((recon - feats) ** 2)
    commit = torch.mean((z - q.detach()) ** 2)
    codebook_loss = torch.mean((z.detach() - q) ** 2)
    return recon_loss + codebook_loss + cfg.commitment_weight * commit


def encode_to_sids(params, feats: torch.Tensor,
                   cfg: RQVAEConfig) -> torch.Tensor:
    """(B, F) item features -> (B, L) int32 Semantic IDs."""
    z = mlp(params["encoder"], feats)
    sids, _, _ = _residual_quantize(params, z)
    return sids.to(torch.int32)


def decode_from_sids(params, sids: torch.Tensor,
                     cfg: RQVAEConfig) -> torch.Tensor:
    """(B, L) Semantic IDs -> reconstructed (B, F) features."""
    q = torch.zeros((sids.shape[0], cfg.latent_dim),
                    device=params["codebooks"].device)
    for lvl in range(cfg.n_levels):
        q = q + params["codebooks"][lvl][sids[:, lvl].long()]
    return mlp(params["decoder"], q)


def assign_dedup_tokens(sids: np.ndarray, codebook_size: int) -> np.ndarray:
    """(N, L') RQ-level codes -> (N, L'+1) with the TIGER dedup token.

    Items that collide on all L' quantizer levels get distinct final tokens
    (their 0-based rank within the collision group, mod ``codebook_size``),
    so every item has a unique Semantic ID as long as no group exceeds the
    codebook.  Host-side numpy, run once per tokenization.
    """
    sids = np.asarray(sids)
    n = sids.shape[0]
    order = np.lexsort(tuple(sids[:, c] for c in
                             range(sids.shape[1] - 1, -1, -1)))
    s = sids[order]
    new_group = np.ones(n, dtype=bool)
    if n > 1:
        new_group[1:] = (s[1:] != s[:-1]).any(axis=1)
    group_start = np.maximum.accumulate(
        np.where(new_group, np.arange(n), 0))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n) - group_start
    return np.concatenate(
        [sids, (rank % codebook_size)[:, None].astype(sids.dtype)], axis=1)
