from .base import (ALL_SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeConfig,
                   TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
from .registry import ARCH_IDS, all_configs, get_config, normalize, reduced_config

__all__ = ["ModelConfig", "ShapeConfig", "ALL_SHAPES", "SHAPES_BY_NAME",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "ARCH_IDS", "get_config", "reduced_config", "all_configs", "normalize"]
