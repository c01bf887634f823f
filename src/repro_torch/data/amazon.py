"""Amazon-Reviews-like cold-start protocol (paper §6); a copy of
``repro.data.amazon``.

The corpus is generated, not downloaded.  It has the same *structure*
as the Amazon subdatasets used by the paper (10-20k items, clustered
features, per-item age), split by the paper's exact protocol:

  * each item has an "age" (timestamp of oldest review);
  * the newest ``cold_frac`` (2% / 5%) of items form the cold-start set;
  * TRAIN sequences contain no cold-start item anywhere;
  * TEST sequences are those whose *target* (last item) is cold-start.

The generative retrieval model therefore never sees a cold item during
training — reproducing the 0.00% unconstrained Recall@1 of Table 3 — and
STATIC constrains decoding to the cold-start SID set at eval.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synthetic import make_item_corpus, make_user_sequences

__all__ = ["ColdStartData", "make_cold_start_dataset"]


@dataclasses.dataclass
class ColdStartData:
    item_feats: np.ndarray  # (N, F)
    item_age: np.ndarray  # (N,) smaller = older
    item_cluster: np.ndarray  # (N,) int cluster id (catalog "category")
    cold_items: np.ndarray  # (n_cold,) item ids
    train_seqs: np.ndarray  # (n_train, T) no cold items anywhere
    test_seqs: np.ndarray  # (n_test, T) target (last) is cold

    @property
    def n_items(self) -> int:
        return self.item_feats.shape[0]

    @property
    def age_days(self) -> np.ndarray:
        """Age rank recast as days-since-publication (newest item = 0).

        ``item_age`` is a recency rank (larger = newer); the constraint
        layer's :func:`~repro_torch.constraints.freshness_window` wants "days
        old", so the newest item maps to 0 and the oldest to ``N - 1``.
        With ``n_cold`` cold items, ``freshness_window(n_cold - 0.5)``
        selects exactly the cold set.
        """
        return (self.n_items - 1 - self.item_age).astype(np.float64)


def make_cold_start_dataset(
    seed: int = 0,
    n_items: int = 2_000,
    n_clusters: int = 64,
    feat_dim: int = 64,
    n_users: int = 6_000,
    seq_len: int = 12,
    cold_frac: float = 0.02,
) -> ColdStartData:
    rng = np.random.default_rng(seed)
    feats, cid = make_item_corpus(rng, n_items, n_clusters, feat_dim)
    age = rng.permutation(n_items)  # rank; larger = newer
    n_cold = max(1, int(n_items * cold_frac))
    cold_items = np.argsort(age)[-n_cold:]
    cold_mask = np.zeros(n_items, bool)
    cold_mask[cold_items] = True

    seqs = make_user_sequences(rng, n_users, seq_len, cid)
    has_cold = cold_mask[seqs].any(axis=1)
    target_cold = cold_mask[seqs[:, -1]]
    train_seqs = seqs[~has_cold]
    test_seqs = seqs[target_cold]
    return ColdStartData(
        item_feats=feats,
        item_age=age,
        item_cluster=cid,
        cold_items=np.sort(cold_items),
        train_seqs=train_seqs,
        test_seqs=test_seqs,
    )
