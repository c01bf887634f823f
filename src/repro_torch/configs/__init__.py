"""Model configurations of the port (copies of ``repro.configs``)."""
from repro_torch.configs.base import TransformerConfig

__all__ = ["TransformerConfig"]
