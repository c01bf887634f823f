"""Transformer, recsys and RQ-VAE config dataclasses, and the registry's
bundle — a copy of ``repro.configs.base``.

Field for field the same as the reference, so a config built for one package
builds the other (``TransformerConfig(**dataclasses.asdict(cfg))``,
``RecsysConfig(**dataclasses.asdict(cfg))``).  The
port's transformer implements the GQA path; it raises on the fields of the
paths still to be ported (MLA, MoE, sliding window, deferred cache writes).
Fields that only steer JAX sharding or XLA lowering are kept for that
one-to-one mapping and are not read here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # expert FFN hidden width
    n_shared: int = 0  # shared (always-on) experts
    d_shared: int = 0  # shared-expert hidden width (n_shared * d_expert if 0)
    first_dense_layers: int = 0  # leading layers that use a dense FFN
    d_ff_dense: int = 0  # width of those dense FFNs
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    dispatch_groups: int = 0


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    qkv_bias: bool = False
    attention: str = "gqa"  # "gqa" (covers MHA/MQA/SWA) | "mla"
    sliding_window: Optional[int] = None
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    # JAX sharding / lowering knobs (kept for the one-to-one field mapping)
    sp_axes: tuple = ()
    use_sp: bool = True
    train_microbatches: int = 1
    layer_unroll: int = 1
    inner_unroll: bool = False
    ce_chunk: int = 256
    defer_cache_write: bool = False
    gr_batched_beams: bool = False
    decode_split_k: bool = False
    serve_replicate_weights: bool = False

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count of the GQA path (embeddings + layers)."""
        D, V, L = self.d_model, self.vocab_size, self.n_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim()
        attn = D * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * D
        return emb + L * (attn + 3 * D * self.d_ff)


# --------------------------------------------------------------------------
# RecSys family
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str  # "wide_deep" | "mind" | "dlrm" | "fm"
    n_dense: int = 0
    n_sparse: int = 26
    embed_dim: int = 32
    vocab_sizes: tuple = ()  # per-sparse-feature rows
    bot_mlp: tuple = ()
    top_mlp: tuple = ()
    mlp: tuple = ()
    interaction: str = "concat"
    # MIND-specific
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    multi_hot: int = 1  # indices per sparse feature (bag arity K)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    kind: str  # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = (
    RecsysShape("train_batch", "train", 65_536),
    RecsysShape("serve_p99", "serve", 512),
    RecsysShape("serve_bulk", "serve", 262_144),
    RecsysShape("retrieval_cand", "retrieval", 1, n_candidates=1_000_000),
)


# --------------------------------------------------------------------------
# RQ-VAE (Semantic-ID tokenizer for the paper's generative retrieval stack)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RQVAEConfig:
    feat_dim: int = 64
    latent_dim: int = 32
    n_levels: int = 4  # SID length L
    codebook_size: int = 256  # |V|
    enc_hidden: tuple = (128, 64)
    commitment_weight: float = 0.25


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    """What the registry hands to the launcher: config + shapes + family."""

    arch_id: str
    family: str  # "lm" | "gnn" | "recsys" | "gr"
    config: object
    shapes: tuple
    notes: str = ""
