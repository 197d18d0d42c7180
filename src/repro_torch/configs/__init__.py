from repro_torch.configs.base import (
    ModelConfig, MoEConfig, MambaConfig, ShapeConfig,
    SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    applicable_shapes, assigned_archs, get_config, list_configs, reduced, register,
)

__all__ = [
    "ModelConfig", "MoEConfig", "MambaConfig", "ShapeConfig",
    "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "applicable_shapes", "assigned_archs", "get_config", "list_configs",
    "reduced", "register",
]
