from repro_torch.configs.base import (
    ModelConfig, MoEConfig, MambaConfig, get_config, list_configs, reduced, register,
)

__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "get_config",
           "list_configs", "reduced", "register"]
