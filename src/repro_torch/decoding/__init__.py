"""Constraint backends and the per-level decode policy of the port.

Public surface, as ``repro.decoding``'s:
  * ``DecodePolicy``        — per-level backend plan; the object serving code
                              passes around.
  * ``as_policy``           — coercion helper: matrix / store / baseline /
                              None -> policy.
  * ``ConstraintBackend``   — the protocol (mask_step + static metadata).
  * ``Impl``, ``Rows``      — the backends' ``impl`` values (``None`` or
                              ``"plain"``, where the reference names
                              ``"xla"``/``"pallas"``) and CSR placements.
  * Backends: ``StaticBackend``, ``StackedStaticBackend``,
    ``CpuTrieBackend``, ``PPVBackend``, ``HashBitmapBackend``,
    ``UnconstrainedBackend``.
"""
from repro_torch.decoding.backends import (
    ConstraintBackend,
    CpuTrieBackend,
    HashBitmapBackend,
    Impl,
    PPVBackend,
    Rows,
    StackedStaticBackend,
    StaticBackend,
    UnconstrainedBackend,
)
from repro_torch.decoding.policy import DecodePolicy, as_policy

__all__ = ["ConstraintBackend", "DecodePolicy", "as_policy", "Impl", "Rows",
           "StaticBackend", "StackedStaticBackend", "CpuTrieBackend",
           "PPVBackend", "HashBitmapBackend", "UnconstrainedBackend"]
