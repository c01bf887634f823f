"""Multi-tenant constraint serving: the stacked ``ConstraintStore``."""
from repro_torch.constraints.store import ConstraintStore, EnvelopeOverflow

__all__ = ["ConstraintStore", "EnvelopeOverflow"]
