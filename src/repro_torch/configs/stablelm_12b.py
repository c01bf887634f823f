"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352.  [hf:stabilityai/stablelm-2-12b family; hf]
Same values as ``repro.configs.stablelm_12b``."""
from repro_torch.configs.base import ArchBundle, LM_SHAPES, TransformerConfig

CONFIG = TransformerConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
)

SHAPES = LM_SHAPES

BUNDLE = ArchBundle(
    arch_id="stablelm-12b",
    family="lm",
    config=CONFIG,
    shapes=SHAPES,
    notes="Pure full attention: long_500k skipped (DESIGN.md §4).",
)
