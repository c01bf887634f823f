"""dlrm-mlperf [recsys] — n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot.
MLPerf DLRM benchmark config (Criteo 1TB).  [arXiv:1906.00091]  Same
values as ``repro.configs.dlrm_mlperf``; its float32 tables (~188M rows x
128, 96 GB) do not fit one card."""
from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig
from repro_torch.models.recsys import DLRM_CRITEO_VOCABS

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
