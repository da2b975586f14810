"""Model configurations (own copies of ``repro.configs``)."""
from repro_torch.configs.base import LoRAConfig, ModelConfig, get_config
from repro_torch.configs.presets import reduce_config

__all__ = ["LoRAConfig", "ModelConfig", "get_config", "reduce_config"]
