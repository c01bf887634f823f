"""Core of the port: trie, transition matrix, VNTK references, the
constrained step, beam search and the §5.2 baselines.

Public surface, as ``repro.core``'s:
  * ``build_flat_trie`` / ``FlatTrie``      — offline trie -> stacked CSR
  * ``random_constraint_set``               — the §5.3 scalability protocol
  * ``TransitionMatrix``                    — device-resident constraint index
  * ``constrain_log_probs``                 — Alg. 1 Phase 2 (dense + VNTK)
  * ``constrained_decoding_step``           — Alg. 1 Phases 1-2
  * ``beam_search`` / ``BeamState``         — Alg. 1 Phases 3-4 driver

``beam_search`` here is the function: it shadows the submodule attribute,
as in the reference, and ``from repro_torch.core.beam_search import ...``
still reaches the module.
"""
from repro_torch.core.baselines import (
    CpuTrieBaseline,
    HashBitmapBaseline,
    PPVBaseline,
    unconstrained_mask,
)
from repro_torch.core.beam_search import BeamState, beam_search, recall_at_k
from repro_torch.core.constrained import (
    constrain_log_probs,
    constrained_decoding_step,
)
from repro_torch.core.transition_matrix import (
    ROOT_STATE,
    SINK_STATE,
    TransitionMatrix,
)
from repro_torch.core.trie import FlatTrie, build_flat_trie, random_constraint_set
from repro_torch.core.vntk import NEG_INF

__all__ = ["BeamState", "beam_search", "recall_at_k", "TransitionMatrix",
           "ROOT_STATE", "SINK_STATE", "NEG_INF", "FlatTrie",
           "build_flat_trie", "random_constraint_set", "constrain_log_probs",
           "constrained_decoding_step", "CpuTrieBaseline", "PPVBaseline",
           "HashBitmapBaseline", "unconstrained_mask"]
