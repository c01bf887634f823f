"""Core of the port: trie, transition matrix, VNTK references, beam search."""
from repro_torch.core.transition_matrix import (
    ROOT_STATE,
    SINK_STATE,
    TransitionMatrix,
)

__all__ = ["TransitionMatrix", "ROOT_STATE", "SINK_STATE"]
