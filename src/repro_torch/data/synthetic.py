"""Synthetic corpora for the generative-retrieval stack (a copy of
``repro.data.synthetic``).

Mirrors the structure the paper relies on: items live in semantic clusters
(so RQ-VAE Semantic IDs share prefixes within a cluster — the "significant
clustering" of Appendix B.2), and user sequences have cluster affinity (so
next-item prediction is learnable by a small transformer).
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_item_corpus", "make_user_sequences"]


def make_item_corpus(
    rng: np.random.Generator,
    n_items: int,
    n_clusters: int,
    feat_dim: int,
    cluster_std: float = 0.15,
):
    """Returns (features (N, F), cluster_id (N,))."""
    centers = rng.normal(size=(n_clusters, feat_dim))
    cid = rng.integers(0, n_clusters, size=n_items)
    feats = centers[cid] + rng.normal(size=(n_items, feat_dim)) * cluster_std
    return feats.astype(np.float32), cid


def make_user_sequences(
    rng: np.random.Generator,
    n_users: int,
    seq_len: int,
    cluster_id: np.ndarray,
    stay_prob: float = 0.85,
):
    """Cluster-sticky random walks over the catalog -> (n_users, seq_len) ids."""
    n_items = cluster_id.shape[0]
    n_clusters = int(cluster_id.max()) + 1
    by_cluster = [np.nonzero(cluster_id == c)[0] for c in range(n_clusters)]
    by_cluster = [b if b.size else np.arange(n_items) for b in by_cluster]
    seqs = np.empty((n_users, seq_len), np.int64)
    cur = rng.integers(0, n_clusters, size=n_users)
    for t in range(seq_len):
        switch = rng.random(n_users) > stay_prob
        cur = np.where(switch, rng.integers(0, n_clusters, n_users), cur)
        for c in range(n_clusters):
            m = cur == c
            if m.any():
                seqs[m, t] = rng.choice(by_cluster[c], size=int(m.sum()))
    return seqs
