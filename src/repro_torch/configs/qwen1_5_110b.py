"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-110B family; hf]
Same values as ``repro.configs.qwen1_5_110b``."""
from repro_torch.configs.base import ArchBundle, LM_SHAPES, TransformerConfig

CONFIG = TransformerConfig(
    name="qwen1.5-110b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
)

SHAPES = LM_SHAPES

BUNDLE = ArchBundle(
    arch_id="qwen1.5-110b",
    family="lm",
    config=CONFIG,
    shapes=SHAPES,
    notes="Pure full attention: long_500k skipped (DESIGN.md §4).",
)
