import os

# Smoke tests and benches must see exactly ONE device; only launch/dryrun.py
# sets xla_force_host_platform_device_count (before importing jax).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_sids(rng, n, vocab, length, clustered=False):
    """Random constraint set; optionally clustered to mimic SID collisions."""
    if not clustered:
        return rng.integers(0, vocab, size=(n, length), dtype=np.int64)
    n_clusters = max(1, n // 8)
    heads = rng.integers(0, vocab, size=(n_clusters, max(1, length // 2)))
    idx = rng.integers(0, n_clusters, size=n)
    tails = rng.integers(0, vocab, size=(n, length - heads.shape[1]))
    return np.concatenate([heads[idx], tails], axis=1).astype(np.int64)
