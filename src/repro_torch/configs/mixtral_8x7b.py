"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff(expert)=14336
vocab=32000; 8 experts top-2; sliding-window attention (4096).
[arXiv:2401.04088; hf]
Same values as ``repro.configs.mixtral_8x7b``."""
from repro_torch.configs.base import ArchBundle, LM_SHAPES, MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336),
)

SHAPES = LM_SHAPES

BUNDLE = ArchBundle(
    arch_id="mixtral-8x7b",
    family="lm",
    config=CONFIG,
    shapes=SHAPES,
    notes=(
        "SWA (window 4096) + ring KV cache => long_500k decode is O(window) "
        "memory and RUNS (the only assigned LM arch with sub-quadratic attn)."
    ),
)
