"""Model configurations of the port (copies of ``repro.configs``)."""
from repro_torch.configs.base import (RECSYS_SHAPES, RecsysConfig,
                                      RecsysShape, TransformerConfig)

__all__ = ["TransformerConfig", "RecsysConfig", "RecsysShape",
           "RECSYS_SHAPES"]
