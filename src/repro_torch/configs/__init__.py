"""Architecture config registry (port of ``repro.configs``). ``load_all()``
imports every ported config module (side-effect registration);
``get_config(name)`` resolves one."""
from repro_torch.configs.base import (ArchConfig, BlockKind, MLAConfig,
                                      MoEConfig, all_configs, get_config,
                                      load_all, register)

# every arch, in the JAX package's order
ARCH_IDS = (
    "bert-base",
    "deepseek-coder-33b",
    "qwen2-0.5b",
    "gemma2-2b",
    "granite-20b",
    "deepseek-v2-236b",
    "mixtral-8x22b",
    "paligemma-3b",
    "xlstm-125m",
    "hubert-xlarge",
    "recurrentgemma-9b",
)

__all__ = ["ArchConfig", "BlockKind", "MLAConfig", "MoEConfig", "register",
           "get_config", "all_configs", "load_all", "ARCH_IDS"]
