"""dlrm-mlperf [recsys] — n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot.
MLPerf DLRM benchmark config (Criteo 1TB).  [arXiv:1906.00091]  Same
values as ``repro.configs.dlrm_mlperf``; its float32 tables (~188M rows x
128, 96 GB) do not fit one card."""
from repro_torch.configs.base import ArchBundle, RECSYS_SHAPES, RecsysConfig

# MLPerf DLRM (Criteo Terabyte) per-table row counts (the reference keeps
# them in ``repro.models.recsys``; ``repro_torch.models.recsys`` re-exports
# them).
DLRM_CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

CONFIG = RecsysConfig(
    name="dlrm-mlperf",
    model="dlrm",
    n_dense=13,
    n_sparse=26,
    embed_dim=128,
    vocab_sizes=DLRM_CRITEO_VOCABS,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    interaction="dot",
    multi_hot=1,
)

SHAPES = RECSYS_SHAPES

BUNDLE = ArchBundle(
    arch_id="dlrm-mlperf",
    family="recsys",
    config=CONFIG,
    shapes=SHAPES,
    notes=(
        "Embedding tables (~188M rows x 128) vocab-sharded over the model "
        "axis; MLPs data-parallel. STATIC inapplicable."
    ),
)
