"""Multi-tenant constraint serving: the stacked ``ConstraintStore``, the
predicate registry with versioned hot swap, the incremental refresh, and
HBM/host tiering of one trie."""
from repro_torch.constraints.refresh import AsyncRefresher, TrieSource
from repro_torch.constraints.registry import (
    CatalogDelta,
    ConstraintRegistry,
    ItemCatalog,
    category_allowlist,
    freshness_window,
    synthetic_catalog,
)
from repro_torch.constraints.store import ConstraintStore, EnvelopeOverflow
from repro_torch.constraints.tiering import (
    TieredTrie,
    TriePrefetcher,
    tiered_beam_search,
)

__all__ = ["ConstraintStore", "EnvelopeOverflow", "ConstraintRegistry",
           "ItemCatalog", "CatalogDelta", "freshness_window",
           "category_allowlist", "synthetic_catalog", "TrieSource",
           "AsyncRefresher", "TieredTrie", "TriePrefetcher",
           "tiered_beam_search"]
