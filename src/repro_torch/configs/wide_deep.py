"""wide-deep [recsys] — n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat.  [arXiv:1606.07792]  Same values as
``repro.configs.wide_deep``."""
from repro_torch.configs.base import ArchBundle, RECSYS_SHAPES, RecsysConfig

# 40 hashed categorical features, production-representative row counts.
_VOCABS = tuple([10_000, 100_000, 1_000_000, 10_000_000] * 10)

CONFIG = RecsysConfig(
    name="wide-deep",
    model="wide_deep",
    n_sparse=40,
    embed_dim=32,
    vocab_sizes=_VOCABS,
    mlp=(1024, 512, 256),
    interaction="concat",
    multi_hot=1,
)

SHAPES = RECSYS_SHAPES

BUNDLE = ArchBundle(
    arch_id="wide-deep",
    family="recsys",
    config=CONFIG,
    shapes=SHAPES,
    notes="STATIC inapplicable (non-autoregressive scorer).",
)
