"""Continuous-batching serving subsystem (DESIGN.md §10).

Counterpart of ``repro.serving.continuous``: step-boundary join/evict over a
paged history KV pool with trie-prefix sharing.  See
:class:`ContinuousServingEngine` for the contract; the sequence-boundary
engine lives one package up (``repro_torch.serving.ServingEngine``).
"""
from repro_torch.serving.continuous.engine import ContinuousServingEngine
from repro_torch.serving.continuous.paged_kv import (
    PagedKVAllocator,
    PrefixShareTable,
)
from repro_torch.serving.continuous.scheduler import SlotState, StepScheduler

__all__ = [
    "ContinuousServingEngine",
    "PagedKVAllocator",
    "PrefixShareTable",
    "StepScheduler",
    "SlotState",
]
