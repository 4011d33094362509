"""--arch registry: id → (full config, reduced smoke config), the reference's list."""

from __future__ import annotations

import importlib
from typing import Dict

from .base import ModelConfig

ARCH_IDS = [
    "mamba2-780m",
    "command-r-35b",
    "qwen1.5-32b",
    "qwen2.5-32b",
    "qwen1.5-0.5b",
    "hymba-1.5b",
    "deepseek-v2-lite-16b",
    "qwen2-moe-a2.7b",
    "musicgen-large",
    "llava-next-34b",
    "rdmabox-paper-100m",   # the paper-era end-to-end training model
]

# published models cut to one pipeline stage (the port's own, not the
# reference's archs): name → the arch whose module holds STAGE, STAGE_REDUCED
STAGE_IDS = {"deepseek-v2-lite-5l": "deepseek-v2-lite-16b"}

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + sorted(STAGE_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    if arch in STAGE_IDS:
        return _module(STAGE_IDS[arch]).STAGE
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    if arch in STAGE_IDS:
        return _module(STAGE_IDS[arch]).STAGE_REDUCED
    return _module(arch).REDUCED


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
