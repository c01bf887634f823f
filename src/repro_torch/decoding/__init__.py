"""Constraint backends and the per-level decode policy of the port."""
from repro_torch.decoding.backends import (
    CpuTrieBackend,
    HashBitmapBackend,
    PPVBackend,
    StackedStaticBackend,
    StaticBackend,
    UnconstrainedBackend,
)
from repro_torch.decoding.policy import DecodePolicy, as_policy

__all__ = ["StaticBackend", "StackedStaticBackend", "CpuTrieBackend",
           "PPVBackend", "HashBitmapBackend", "UnconstrainedBackend",
           "DecodePolicy", "as_policy"]
