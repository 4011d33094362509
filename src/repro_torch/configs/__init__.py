from .base import ModelConfig, RunConfig, replace
from .registry import ARCH_IDS, get_config, get_reduced

__all__ = ["ModelConfig", "RunConfig", "replace", "ARCH_IDS", "get_config",
           "get_reduced"]
