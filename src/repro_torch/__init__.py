"""PyTorch/CUDA port of the STATIC constrained generative-retrieval stack.

The package mirrors ``repro`` (the JAX reference) module for module; the
VNTK constraint step runs as hand-written CUDA kernels on the card
(``repro_torch.kernels``).  It imports neither JAX nor ``repro``.

Entry points run on the card unless the caller passes ``device="cpu"``;
see :func:`resolve_device`.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (the default) and the process sees no
    card, so no entry point silently moves to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
