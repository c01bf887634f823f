"""Model configurations of the port (copies of ``repro.configs``) and the
architecture registry: ``--arch <id>`` resolution, shape applicability and
reduced smoke configs.

The ten assigned architectures and the paper's own ``static-gr``, as in the
reference.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (codeqwen1_5_7b, deepseek_v2_lite_16b,
                                 dlrm_mlperf, fm, meshgraphnet, mind,
                                 mixtral_8x7b, qwen1_5_110b, stablelm_12b,
                                 static_gr, wide_deep)
from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                      ArchBundle, GNNConfig, GraphShape,
                                      LMShape, MoEConfig, RecsysConfig,
                                      RecsysShape, RQVAEConfig,
                                      TransformerConfig)

__all__ = ["ARCHS", "ASSIGNED", "get_bundle", "supports_shape",
           "smoke_config", "ArchBundle", "TransformerConfig", "MoEConfig",
           "GNNConfig", "GraphShape", "LMShape", "RecsysConfig",
           "RecsysShape", "RQVAEConfig", "LM_SHAPES", "GNN_SHAPES",
           "RECSYS_SHAPES"]

ARCHS: dict[str, ArchBundle] = {
    b.arch_id: b
    for b in [
        stablelm_12b.BUNDLE,
        qwen1_5_110b.BUNDLE,
        codeqwen1_5_7b.BUNDLE,
        deepseek_v2_lite_16b.BUNDLE,
        mixtral_8x7b.BUNDLE,
        meshgraphnet.BUNDLE,
        wide_deep.BUNDLE,
        mind.BUNDLE,
        dlrm_mlperf.BUNDLE,
        fm.BUNDLE,
        static_gr.BUNDLE,
    ]
}

ASSIGNED = [a for a in ARCHS if a != "static-gr"]


def get_bundle(arch_id: str) -> ArchBundle:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def supports_shape(arch_id: str, shape_name: str) -> tuple[bool, str]:
    """Shape-cell applicability (DESIGN.md §4 skip rules)."""
    b = get_bundle(arch_id)
    if b.family == "lm" and shape_name == "long_500k":
        cfg: TransformerConfig = b.config
        if cfg.sliding_window is not None:
            return True, "SWA ring cache: O(window) decode"
        if cfg.attention == "mla":
            return True, "BONUS cell: MLA latent cache (~0.6 GB at 500k)"
        return False, "pure full attention — skipped per shape rules"
    return True, ""


def smoke_config(arch_id: str):
    """Reduced same-family config for CPU smoke tests, field for field the
    reference's ``smoke_config``."""
    b = get_bundle(arch_id)
    if b.family in ("lm", "gr"):
        cfg: TransformerConfig = b.config
        moe = cfg.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe,
                n_experts=4,
                top_k=min(2, moe.top_k),
                d_expert=64,
                d_shared=(128 if moe.n_shared else 0),
                d_ff_dense=(96 if moe.first_dense_layers else 0),
            )
        return dataclasses.replace(
            cfg,
            name=cfg.name + "-smoke",
            n_layers=2 + (moe.first_dense_layers if moe else 0),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
            d_ff=96,
            vocab_size=128,
            head_dim=16,
            kv_lora_rank=32 if cfg.attention == "mla" else 0,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            sliding_window=8 if cfg.sliding_window else None,
            moe=moe,
            attn_chunk_q=8,
            attn_chunk_kv=8,
            dtype="float32",
        )
    if b.family == "gnn":
        return dataclasses.replace(
            b.config, name=b.config.name + "-smoke", n_layers=2, d_hidden=16,
            node_feat_dim=5, edge_feat_dim=3, out_dim=2, dtype="float32",
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
