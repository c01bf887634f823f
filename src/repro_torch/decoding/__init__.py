"""Constraint backends and the per-level decode policy of the port."""
from repro_torch.decoding.backends import StackedStaticBackend, StaticBackend
from repro_torch.decoding.policy import DecodePolicy, as_policy

__all__ = ["StaticBackend", "StackedStaticBackend", "DecodePolicy", "as_policy"]
