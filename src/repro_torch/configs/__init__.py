from .base import SHAPES, ModelConfig, RunConfig, ShapeConfig, cell_supported, replace
from .registry import ARCH_IDS, all_configs, get_config, get_reduced

__all__ = ["ModelConfig", "RunConfig", "ShapeConfig", "SHAPES",
           "cell_supported", "replace", "ARCH_IDS", "all_configs",
           "get_config", "get_reduced"]
