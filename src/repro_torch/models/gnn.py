"""MeshGraphNet (encode-process-decode GNN, arXiv:2010.03409;
``repro.models.gnn``).

Edge update ``e' = e + norm(MLP([e, x_src, x_dst]))``; node update
``x' = x + norm(MLP([x, sum_in(e')]))``; ``n_layers`` processor steps, each
under ``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
``jax.checkpoint`` of the scan body).  The reference's ``segment_sum`` over
the receivers is ``index_add_`` here, in the edge features' dtype; on the
card its atomics add a node's messages in no fixed order.

Parameters are a plain dict mirroring the reference pytree, with the
stacked ``processor`` unstacked into a list of per-layer dicts::

    {"node_enc": MLP, "edge_enc": MLP, "decoder": MLP,
     "processor": [{"edge_mlp": MLP, "node_mlp": MLP,
                    "edge_norm": {"scale"}, "node_norm": {"scale"}}, ...]}

Full graphs, padded subgraphs from the fanout sampler
(:mod:`repro_torch.data.graph_sampler`, with a ``node_mask``) and batched
small graphs (a leading batch axis, run as one graph of disjoint parts) all
go through :func:`forward`.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import GNNConfig
from repro_torch.models.layers import (_generator, mlp, mlp_init, rms_norm,
                                       rms_norm_init)

__all__ = ["init_params", "param_specs", "forward", "gnn_loss",
           "torch_dtype"]


def torch_dtype(cfg: GNNConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _mlp_dims(cfg: GNNConfig, d_in: int) -> tuple:
    return (d_in,) + (cfg.d_hidden,) * cfg.mlp_layers


def init_params(cfg: GNNConfig, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    in the reference's distributions (He-normal weights, zero biases, unit
    norm scales); use :func:`repro_torch.convert.gnn_params_from_jax` to
    compute with the reference's weights.  ``device="meta"`` gives
    :func:`param_specs`."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    gen = _generator(dev, seed)
    H = cfg.d_hidden
    return {
        "node_enc": mlp_init(gen, _mlp_dims(cfg, cfg.node_feat_dim), dt,
                             device=dev),
        "edge_enc": mlp_init(gen, _mlp_dims(cfg, cfg.edge_feat_dim), dt,
                             device=dev),
        "decoder": mlp_init(gen, (H, H, cfg.out_dim), dt, device=dev),
        "processor": [
            {"edge_mlp": mlp_init(gen, _mlp_dims(cfg, 3 * H), dt, device=dev),
             "node_mlp": mlp_init(gen, _mlp_dims(cfg, 2 * H), dt, device=dev),
             "edge_norm": rms_norm_init(H, dt, dev),
             "node_norm": rms_norm_init(H, dt, dev)}
            for _ in range(cfg.n_layers)
        ],
    }


def param_specs(cfg: GNNConfig):
    """:func:`init_params`' tree as ``meta`` tensors (no allocation)."""
    return init_params(cfg, device="meta")


def _step(p, x, e, senders, receivers, cfg: GNNConfig):
    """One processor layer over the (x, e) carry."""
    x_src = x.index_select(0, senders)
    x_dst = x.index_select(0, receivers)
    e = e + rms_norm(p["edge_norm"], mlp(p["edge_mlp"],
                                         torch.cat([e, x_src, x_dst], -1)))
    agg = e.new_zeros((x.shape[0], e.shape[1])).index_add(0, receivers, e)
    if cfg.aggregator == "mean":
        deg = e.new_zeros((x.shape[0], 1)).index_add(
            0, receivers, e.new_ones((e.shape[0], 1)))
        agg = agg / deg.clamp_min(1.0)
    x = x + rms_norm(p["node_norm"], mlp(p["node_mlp"],
                                         torch.cat([x, agg.to(x.dtype)], -1)))
    return x, e


def forward(params, node_feats: torch.Tensor, edge_feats: torch.Tensor,
            senders: torch.Tensor, receivers: torch.Tensor, cfg: GNNConfig,
            node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Node outputs (N, out_dim) of one graph: node_feats (N, F_n),
    edge_feats (E, F_e), senders/receivers (E,) node ids; outputs of nodes
    outside ``node_mask`` (N,) are zeroed.  The features are cast to the
    parameters' dtype (torch multiplies no float32 by bfloat16; the
    reference promotes such a product to float32).

    A leading batch axis — node_feats (B, N, F_n), edge_feats (B, E, F_e),
    senders/receivers (B, E) — runs the B graphs as one graph of B disjoint
    parts (graph b's ids offset by b * N) and returns (B, N, out_dim), what
    a per-graph loop returns.
    """
    if node_feats.dim() == 3:
        B, N = node_feats.shape[:2]
        offset = (torch.arange(B, device=senders.device) * N)[:, None]
        out = forward(params, node_feats.reshape(B * N, -1),
                      edge_feats.reshape(-1, edge_feats.shape[-1]),
                      (senders.long() + offset).reshape(-1),
                      (receivers.long() + offset).reshape(-1), cfg,
                      None if node_mask is None else node_mask.reshape(-1))
        return out.reshape(B, N, -1)
    senders, receivers = senders.long(), receivers.long()
    dt = params["node_enc"]["l0"]["w"].dtype
    x = mlp(params["node_enc"], node_feats.to(dt))
    e = mlp(params["edge_enc"], edge_feats.to(dt))
    remat = cfg.remat and torch.is_grad_enabled()
    for p in params["processor"]:
        if remat:
            x, e = torch.utils.checkpoint.checkpoint(
                _step, p, x, e, senders, receivers, cfg, use_reentrant=False)
        else:
            x, e = _step(p, x, e, senders, receivers, cfg)
    out = mlp(params["decoder"], x)
    if node_mask is not None:
        out = out * node_mask[:, None].to(out.dtype)
    return out


def gnn_loss(params, batch, cfg: GNNConfig) -> torch.Tensor:
    """L2 regression on node targets (MeshGraphNet's training objective),
    averaged over the nodes in ``batch["node_mask"]`` when it is given.
    As in the reference, a batched input (3-D ``node_feats``) is forwarded
    without the mask, which then only weighs the loss."""
    mask = batch.get("node_mask")
    pred = forward(params, batch["node_feats"], batch["edge_feats"],
                   batch["senders"], batch["receivers"], cfg,
                   node_mask=mask if batch["node_feats"].dim() == 2 else None)
    err = (pred.float() - batch["targets"].float()) ** 2
    if mask is not None:
        m = mask.float()
        return torch.sum(err * m[..., None]) / (torch.sum(m) * err.shape[-1]
                                                + 1e-9)
    return torch.mean(err)
