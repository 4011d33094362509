from .base import ModelConfig, replace
from .registry import ARCH_IDS, get_config, get_reduced

__all__ = ["ModelConfig", "replace", "ARCH_IDS", "get_config", "get_reduced"]
