"""meshgraphnet [gnn] — n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2.
[arXiv:2010.03409; unverified]
Same values as ``repro.configs.meshgraphnet``."""
from repro_torch.configs.base import ArchBundle, GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(
    name="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    mlp_layers=2,
    aggregator="sum",
    node_feat_dim=16,  # overridden per shape (d_feat)
    edge_feat_dim=8,
    out_dim=3,
)

SHAPES = GNN_SHAPES

BUNDLE = ArchBundle(
    arch_id="meshgraphnet",
    family="gnn",
    config=CONFIG,
    shapes=SHAPES,
    notes=(
        "STATIC inapplicable (no autoregressive decode) — see DESIGN.md "
        "§Arch-applicability. minibatch_lg uses the fanout 15-10 neighbor "
        "sampler in repro_torch.data.graph_sampler."
    ),
)
