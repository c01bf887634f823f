"""Fanout neighbor sampler for GNN minibatch training (GraphSAGE-style),
a numpy copy of ``repro.data.graph_sampler``: the same ``np.random``
draws in the same order, so one seed gives array-equal subgraphs.

``minibatch_lg`` requires a real sampler: given a CSR adjacency, sample
``fanout`` neighbors per hop from seed nodes and emit a *padded, fixed-shape*
subgraph (node list, edge list, mask) — fixed shapes keep every step's
tensors the same size.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CSRGraph", "fanout_sample", "random_graph"]


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,) neighbor ids
    node_feats: np.ndarray  # (N, F)

    @property
    def n_nodes(self):
        return self.indptr.shape[0] - 1


def random_graph(rng, n_nodes: int, avg_degree: int, feat_dim: int) -> CSRGraph:
    deg = rng.poisson(avg_degree, n_nodes).clip(1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n_nodes, indptr[-1])
    feats = rng.normal(size=(n_nodes, feat_dim)).astype(np.float32)
    return CSRGraph(indptr, indices, feats)


def fanout_sample(
    g: CSRGraph,
    seeds: np.ndarray,
    fanout: tuple,
    rng: np.random.Generator,
    edge_feat_dim: int = 8,
):
    """Sample a fanout subgraph; returns fixed-shape padded arrays.

    Output sizes: nodes = len(seeds) * (1 + f1 + f1*f2 + ...),
                  edges = len(seeds) * (f1 + f1*f2 + ...).
    Local node ids: seeds first, then hop-1 samples, then hop-2, ...
    Edges point child -> parent (message flows toward the seeds).
    """
    n_seeds = seeds.shape[0]
    sizes = np.cumprod(fanout)
    n_pad_nodes = n_seeds * (1 + int(sizes.sum()))
    n_pad_edges = n_seeds * int(sizes.sum())

    local_nodes = np.zeros(n_pad_nodes, np.int64)
    node_mask = np.zeros(n_pad_nodes, bool)
    senders = np.zeros(n_pad_edges, np.int64)
    receivers = np.zeros(n_pad_edges, np.int64)
    edge_mask = np.zeros(n_pad_edges, bool)

    local_nodes[:n_seeds] = seeds
    node_mask[:n_seeds] = True
    frontier_lo, frontier_n = 0, n_seeds
    node_cursor, edge_cursor = n_seeds, 0

    for f in fanout:
        parents = local_nodes[frontier_lo : frontier_lo + frontier_n]
        pmask = node_mask[frontier_lo : frontier_lo + frontier_n]
        for j in range(frontier_n):
            base_n = node_cursor + j * f
            base_e = edge_cursor + j * f
            if not pmask[j]:
                continue
            p = parents[j]
            lo, hi = g.indptr[p], g.indptr[p + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, int(deg))
            picks = g.indices[lo + rng.choice(deg, size=take, replace=deg < f)]
            local_nodes[base_n : base_n + take] = picks
            node_mask[base_n : base_n + take] = True
            senders[base_e : base_e + take] = np.arange(base_n, base_n + take)
            receivers[base_e : base_e + take] = frontier_lo + j
            edge_mask[base_e : base_e + take] = True
        frontier_lo = node_cursor
        frontier_n = frontier_n * f
        node_cursor += frontier_n
        edge_cursor += frontier_n

    feats = g.node_feats[local_nodes] * node_mask[:, None]
    edge_feats = np.zeros((n_pad_edges, edge_feat_dim), np.float32)
    edge_feats[:, 0] = edge_mask.astype(np.float32)
    # masked edges scatter to node 0 with zero features — harmless because
    # their messages are zeroed by edge_feats*edge_mask in the caller's loss.
    return {
        "node_feats": feats.astype(np.float32),
        "edge_feats": edge_feats,
        "senders": senders.astype(np.int32),
        "receivers": receivers.astype(np.int32),
        "node_mask": node_mask,
        "edge_mask": edge_mask,
        "local_to_global": local_nodes,
    }
