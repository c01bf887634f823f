"""Deterministic sharded batch loader (a copy of ``repro.data.loader``).

Epoch order is a pure function of (seed, epoch); every host slices its own
contiguous shard, so (a) any host can be restarted and recompute exactly the
batches it owes (fault tolerance), and (b) resume-from-checkpoint replays
from an exact (epoch, cursor) data state with no coordination.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ShardedBatcher"]


class ShardedBatcher:
    def __init__(
        self,
        arrays: dict,
        global_batch: int,
        seed: int = 0,
        n_hosts: int = 1,
        host_id: int = 0,
        drop_remainder: bool = True,
    ):
        n = next(iter(arrays.values())).shape[0]
        for k, v in arrays.items():
            if v.shape[0] != n:
                raise ValueError(f"array {k} length mismatch")
        if global_batch % n_hosts:
            raise ValueError("global_batch must divide by n_hosts")
        self.arrays = arrays
        self.n = n
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.epoch = 0
        self.cursor = 0  # in global batches
        self.drop_remainder = drop_remainder

    # -- state for exact resume ------------------------------------------
    def state(self) -> dict:
        return {"epoch": self.epoch, "cursor": self.cursor}

    def restore(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])

    # ----------------------------------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n)

    def __iter__(self):
        return self

    def __next__(self):
        batches_per_epoch = self.n // self.global_batch
        if batches_per_epoch == 0:
            raise ValueError("dataset smaller than one global batch")
        if self.cursor >= batches_per_epoch:
            self.epoch += 1
            self.cursor = 0
        order = self._epoch_order(self.epoch)
        start = self.cursor * self.global_batch
        idx = order[start : start + self.global_batch]
        lo = self.host_id * self.local_batch
        idx = idx[lo : lo + self.local_batch]
        self.cursor += 1
        return {k: v[idx] for k, v in self.arrays.items()}
