"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32 == MHA)
d_ff=13440 vocab=92416, qwen1.5 arch (QKV bias).  [hf:Qwen/CodeQwen1.5-7B; hf]
Same values as ``repro.configs.codeqwen1_5_7b``."""
from repro_torch.configs.base import ArchBundle, LM_SHAPES, TransformerConfig

CONFIG = TransformerConfig(
    name="codeqwen1.5-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
)

SHAPES = LM_SHAPES

BUNDLE = ArchBundle(
    arch_id="codeqwen1.5-7b",
    family="lm",
    config=CONFIG,
    shapes=SHAPES,
    notes="Pure full attention: long_500k skipped (DESIGN.md §4).",
)
