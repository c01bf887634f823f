"""fm [recsys] — n_sparse=39 embed_dim=10 interaction=fm-2way; pairwise
<v_i, v_j> x_i x_j via the O(nk) sum-square trick.  [ICDM'10 (Rendle)]
Same values as ``repro.configs.fm``."""
from repro_torch.configs.base import ArchBundle, RECSYS_SHAPES, RecsysConfig

# Criteo-style 39 features (26 categorical + 13 bucketized integer).
_VOCABS = tuple([1_000_000] * 26 + [1_000] * 13)

CONFIG = RecsysConfig(
    name="fm",
    model="fm",
    n_sparse=39,
    embed_dim=10,
    vocab_sizes=_VOCABS,
    interaction="fm-2way",
    multi_hot=1,
)

SHAPES = RECSYS_SHAPES

BUNDLE = ArchBundle(
    arch_id="fm",
    family="recsys",
    config=CONFIG,
    shapes=SHAPES,
    notes="STATIC inapplicable (non-autoregressive scorer).",
)
