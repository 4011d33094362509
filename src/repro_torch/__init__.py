"""PyTorch / CUDA port of the ``repro`` serving stack, for one NVIDIA H100.

Module names follow ``repro`` so each module's reference is easy to find.
The package imports torch and numpy only: never JAX, never ``repro``.
Entry points run on ``cuda`` unless the caller asks for ``"cpu"``; on a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda", *,
                   allow_meta: bool = False) -> torch.device:
    """``"cpu"`` stays the CPU; ``"meta"`` (shapes only, nothing allocated)
    only where the caller allows it, as the dry run's model construction
    does; anything else must be a visible CUDA device."""
    dev = torch.device(device)
    if dev.type == "cpu" or (dev.type == "meta" and allow_meta):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


__all__ = ["resolve_device"]
