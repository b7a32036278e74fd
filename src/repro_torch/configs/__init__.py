from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, TRAIN_4K, ModelConfig,
                                      ShapeConfig)
from repro_torch.configs.registry import REGISTRY, smoke_config

__all__ = ["ALL_SHAPES", "DECODE_32K", "LONG_500K", "ModelConfig",
           "PREFILL_32K", "REGISTRY", "ShapeConfig", "TRAIN_4K",
           "get_config", "get_shape", "smoke_config"]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
