"""Core of the port: trie, transition matrix, VNTK references, the
constrained step, beam search and the §5.2 baselines."""
from repro_torch.core.baselines import (
    CpuTrieBaseline,
    HashBitmapBaseline,
    PPVBaseline,
    unconstrained_mask,
)
from repro_torch.core.constrained import (
    constrain_log_probs,
    constrained_decoding_step,
)
from repro_torch.core.transition_matrix import (
    ROOT_STATE,
    SINK_STATE,
    TransitionMatrix,
)
from repro_torch.core.vntk import NEG_INF

__all__ = ["TransitionMatrix", "ROOT_STATE", "SINK_STATE", "NEG_INF",
           "constrain_log_probs", "constrained_decoding_step",
           "CpuTrieBaseline", "PPVBaseline", "HashBitmapBaseline",
           "unconstrained_mask"]
