"""Config dataclasses of every architecture family, their input-shape
specs, and the registry's bundle — a copy of ``repro.configs.base``.

Field for field the same as the reference, so a config built for one package
builds the other (``TransformerConfig(**dataclasses.asdict(cfg))``,
``GNNConfig(**...)``, ``RecsysConfig(**...)``).  Fields that only steer JAX
sharding or XLA lowering (``sp_axes``, ``layer_unroll``, ``decode_split_k``,
...) are kept for that one-to-one mapping and are not read here.  A model
served at its published settings (DeepSeek-V2-Lite) needs what the reference
lacks: ``MoEConfig.norm_topk_prob`` and ``TransformerConfig.rope_scaling``
(YaRN, :class:`RopeScaling`), two fields of the port's own, and
``MoEConfig.capacity_factor=None`` (dropless routing).  Their defaults are
the reference's behaviour.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """YaRN rotary scaling, as DeepSeek-V2's ``rope_scaling`` states it:
    frequencies past the correction range are divided by ``factor``, those
    inside it ramped, and attention's softmax scale is multiplied by
    ``mscale(factor, mscale_all_dim) ** 2`` (read by MLA attention)."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # expert FFN hidden width
    n_shared: int = 0  # shared (always-on) experts
    d_shared: int = 0  # shared-expert hidden width (n_shared * d_expert if 0)
    first_dense_layers: int = 0  # leading layers that use a dense FFN
    d_ff_dense: int = 0  # width of those dense FFNs
    # None: dropless (every assignment is computed, whatever the batch)
    capacity_factor: Optional[float] = 1.25
    router_aux_weight: float = 0.01
    # GShard-style dispatch groups PER SEQUENCE: 0 = one flat dispatch
    # over all tokens; g >= 1 splits (B, S) into B*g groups of S/g tokens,
    # each with its own capacity and position cumsum.
    dispatch_groups: int = 0
    # divide the top-k weights by their sum (False: the raw softmax weights)
    norm_topk_prob: bool = True


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
    sliding_window: Optional[int] = None  # SWA window (Mixtral: 4096)
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- misc ---
    rope_theta: float = 10_000.0
    rope_scaling: Optional[RopeScaling] = None  # YaRN (MLA attention)
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

    def __post_init__(self):
        # ``dataclasses.asdict`` of a reference config nests ``moe`` as a dict
        if isinstance(self.moe, dict):
            object.__setattr__(self, "moe", MoEConfig(**self.moe))
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling",
                               RopeScaling(**self.rope_scaling))

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        D, V, L = self.d_model, self.vocab_size, self.n_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.attention == "mla":
            hd = self.qk_nope_head_dim + self.qk_rope_head_dim
            attn = (
                D * self.n_heads * hd  # q proj
                + D * (self.kv_lora_rank + self.qk_rope_head_dim)  # kv down
                + self.kv_lora_rank * self.n_heads
                * (self.qk_nope_head_dim + self.v_head_dim)  # kv up
                + self.n_heads * self.v_head_dim * D  # o proj
            )
        else:
            hd = self.resolved_head_dim()
            attn = (D * hd * (self.n_heads + 2 * self.n_kv_heads)
                    + self.n_heads * hd * D)
        if self.moe is None:
            return emb + L * (attn + 3 * D * self.d_ff)
        m = self.moe
        moe_ffn = 3 * D * m.d_expert * m.n_experts + D * m.n_experts
        shared = (3 * D * (m.d_shared or m.n_shared * m.d_expert)
                  if m.n_shared else 0)
        dense = 3 * D * (m.d_ff_dense or self.d_ff)
        return emb + (m.first_dense_layers * (attn + dense)
                      + (L - m.first_dense_layers) * (attn + moe_ffn + shared))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if self.moe is None:
            return self.param_count()
        D, L, m = self.d_model, self.n_layers, self.moe
        moe_total = 3 * D * m.d_expert * m.n_experts
        moe_active = 3 * D * m.d_expert * m.top_k
        return self.param_count() - (L - m.first_dense_layers) * (
            moe_total - moe_active)


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


LM_SHAPES = (
    LMShape("train_4k", "train", 4_096, 256),
    LMShape("prefill_32k", "prefill", 32_768, 32),
    LMShape("decode_32k", "decode", 32_768, 128),
    LMShape("long_500k", "decode", 524_288, 1),
)


# --------------------------------------------------------------------------
# GNN family
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    aggregator: str = "sum"
    node_feat_dim: int = 16
    edge_feat_dim: int = 8
    out_dim: int = 3
    dtype: str = "bfloat16"
    remat: bool = True
    layer_unroll: int = 1  # XLA lowering knob of the reference; not read here


@dataclasses.dataclass(frozen=True)
class GraphShape:
    name: str
    kind: str  # "full" | "sampled" | "batched"
    n_nodes: int
    n_edges: int
    d_feat: int
    batch: int = 1
    batch_nodes: int = 0
    fanout: tuple = ()


GNN_SHAPES = (
    GraphShape("full_graph_sm", "full", 2_708, 10_556, 1_433),
    GraphShape(
        "minibatch_lg", "sampled", 232_965, 114_615_892, 602,
        batch_nodes=1_024, fanout=(15, 10),
    ),
    GraphShape("ogb_products", "full", 2_449_029, 61_859_140, 100),
    GraphShape("molecule", "batched", 30, 64, 16, batch=128),
)


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
