"""--arch registry: id → (full config, reduced smoke config), ported archs only."""

from __future__ import annotations

import importlib

from .base import ModelConfig

ARCH_IDS = ["qwen1.5-0.5b", "mamba2-780m"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet (ROADMAP item 9); "
            f"ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED
