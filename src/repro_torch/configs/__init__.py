from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import REGISTRY, smoke_config

__all__ = ["ModelConfig", "REGISTRY", "get_config", "smoke_config"]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
