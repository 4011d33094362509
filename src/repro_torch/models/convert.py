"""Load the reference's parameter tree into the port's ``Transformer``.

``params_np`` is ``repro.models.init_stack``'s tree with numpy leaves
(``jax.tree.map(np.asarray, params)``). Block leaves are stacked on a
leading layer axis there; here each layer has its own module, so leaf
``blocks/attn/wq`` of shape (L, M, H·D) feeds ``blocks.{l}.attn.wq``.
Weights keep the reference's (in, out) orientation. bf16 leaves arrive
as ``ml_dtypes.bfloat16``, which torch cannot take, so every leaf goes
through float32 (exact for bf16) and then to the parameter's dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from .transformer import Transformer


def _leaves(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_leaves(val, path + "."))
        else:
            out[path] = val
    return out


@torch.no_grad()
def from_reference_params(params_np: Dict[str, Any], cfg: ModelConfig,
                          device: str | torch.device = "cuda",
                          dtype: Optional[torch.dtype] = None) -> Transformer:
    """A ``Transformer`` holding ``params_np``'s leaves; every parameter in
    ``dtype`` if given (an f32 copy of bf16 weights, or a gradient tree read
    back in f32), else in the port's own dtypes."""
    model = Transformer(cfg, device=device)
    if dtype is not None:
        model.to(dtype)
    ref = _leaves(params_np)
    used = set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":                 # blocks.<l>.<path> ← blocks.<path>[l]
            key = ".".join(["blocks", *parts[2:]])
            leaf = np.asarray(ref[key])[int(parts[1])] if key in ref else None
        else:
            key = name
            leaf = ref.get(key)
        if leaf is None:
            raise KeyError(f"reference params have no leaf for {name}")
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(leaf.shape)} "
                             f"vs port {tuple(p.shape)}")
        p.copy_(torch.tensor(np.asarray(leaf, np.float32)))
        used.add(key)
    unused = set(ref) - used
    if unused:
        raise KeyError(f"reference leaves with no port parameter: {sorted(unused)}")
    return model
