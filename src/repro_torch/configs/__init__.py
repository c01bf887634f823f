"""Model configurations of the port (copies of ``repro.configs``) and the
architecture registry: ``--arch <id>`` resolution and reduced smoke configs.

The port carries five of the reference's eleven architectures: the paper's
own ``static-gr`` and the four recsys models.  The other six (five LM
decoders with MLA, MoE or sliding-window attention, and meshgraphnet) are
ROADMAP.md item 15; asking for one raises a ``KeyError`` that says so.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import dlrm_mlperf, fm, mind, static_gr, wide_deep
from repro_torch.configs.base import (RECSYS_SHAPES, ArchBundle, RecsysConfig,
                                      RecsysShape, RQVAEConfig,
                                      TransformerConfig)

__all__ = ["ARCHS", "NOT_PORTED", "get_bundle", "smoke_config",
           "ArchBundle", "TransformerConfig", "RecsysConfig", "RecsysShape",
           "RQVAEConfig", "RECSYS_SHAPES"]

ARCHS: dict[str, ArchBundle] = {
    b.arch_id: b
    for b in [wide_deep.BUNDLE, mind.BUNDLE, dlrm_mlperf.BUNDLE, fm.BUNDLE,
              static_gr.BUNDLE]
}

# the reference's architectures this port does not carry yet
NOT_PORTED = ("stablelm-12b", "qwen1.5-110b", "codeqwen1.5-7b",
              "deepseek-v2-lite-16b", "mixtral-8x7b", "meshgraphnet")


def get_bundle(arch_id: str) -> ArchBundle:
    if arch_id in NOT_PORTED:
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ROADMAP.md "
            f"item 15); ported: {sorted(ARCHS)}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def smoke_config(arch_id: str):
    """Reduced same-family config for CPU smoke tests, field for field the
    reference's ``smoke_config`` for the ``gr`` and ``recsys`` families."""
    b = get_bundle(arch_id)
    if b.family == "gr":
        cfg: TransformerConfig = b.config
        return dataclasses.replace(
            cfg,
            name=cfg.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
            d_ff=96,
            vocab_size=128,
            head_dim=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            attn_chunk_q=8,
            attn_chunk_kv=8,
            dtype="float32",
        )
    if b.family == "recsys":
        cfg: RecsysConfig = b.config
        return dataclasses.replace(
            cfg,
            name=cfg.name + "-smoke",
            vocab_sizes=tuple(min(v, 50) for v in cfg.vocab_sizes),
            embed_dim=8,
            mlp=tuple(16 for _ in cfg.mlp),
            bot_mlp=(tuple([16] * (len(cfg.bot_mlp) - 1) + [8])
                     if cfg.bot_mlp else ()),
            top_mlp=(tuple([16] * (len(cfg.top_mlp) - 1) + [1])
                     if cfg.top_mlp else ()),
            hist_len=6,
        )
    raise ValueError(b.family)
