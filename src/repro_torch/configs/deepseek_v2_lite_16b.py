"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400; MLA kv_lora=512; 2 shared + 64 routed experts top-6; first
layer dense (d_ff=10944).  [arXiv:2405.04434; hf]
Same values as ``repro.configs.deepseek_v2_lite_16b``."""
from repro_torch.configs.base import ArchBundle, LM_SHAPES, MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,  # dense-layer FFN width
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        d_shared=2 * 1408,
        first_dense_layers=1,
        d_ff_dense=10944,
    ),
)

SHAPES = LM_SHAPES

BUNDLE = ArchBundle(
    arch_id="deepseek-v2-lite-16b",
    family="lm",
    config=CONFIG,
    shapes=SHAPES,
    notes=(
        "MLA latent KV cache makes 500k-token decode memory-light "
        "(~0.6 GB latents) — long_500k run as a BONUS cell; per the shape "
        "rules MLA is still full attention, so the cell is marked bonus in "
        "EXPERIMENTS.md rather than a sub-quadratic substitute."
    ),
)
