"""Architecture config registry (port of ``repro.configs``)."""
from repro_torch.configs.base import (ArchConfig, BlockKind, MLAConfig,
                                      MoEConfig, get_config, register)

__all__ = ["ArchConfig", "BlockKind", "MLAConfig", "MoEConfig", "register",
           "get_config"]
