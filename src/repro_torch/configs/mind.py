"""mind [recsys] — embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest.  [arXiv:1904.08030]  Same values as
``repro.configs.mind``."""
from repro_torch.configs.base import ArchBundle, RECSYS_SHAPES, RecsysConfig

CONFIG = RecsysConfig(
    name="mind",
    model="mind",
    n_sparse=1,  # single item-id table
    embed_dim=64,
    vocab_sizes=(10_000_000,),  # item corpus
    n_interests=4,
    capsule_iters=3,
    hist_len=50,
    interaction="multi-interest",
)

SHAPES = RECSYS_SHAPES

BUNDLE = ArchBundle(
    arch_id="mind",
    family="recsys",
    config=CONFIG,
    shapes=SHAPES,
    notes=(
        "retrieval_cand scores 1M candidates with a single batched "
        "max-over-interests dot (no loop). STATIC inapplicable."
    ),
)
