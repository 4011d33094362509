"""Plain-torch AdamW over a dict of leaves: the oracle of ``csrc/adamw.cu``.

``clip_by_global_norm_plain`` scales every gradient, in f32, to a global L2
norm of at most ``max_norm``; ``adamw_plain`` takes one AdamW step of every
leaf from those gradients, one PyTorch operation at a time. The arithmetic
is the reference's (``repro/optim/adamw.py``): each gradient is clipped in
f32 (the reference's ``g * scale`` promotes a bf16 leaf to f32), the moments
are f32, weight decay goes on leaves of ``ndim >= 2``, and each parameter is
rounded back to its own dtype in place. These run wherever the kernel does
not: off the card, on CPU tensors and on meta tensors (the dry run), DTensors
or not.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@torch.no_grad()
def clip_by_global_norm_plain(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """Grads in f32 scaled to a global L2 norm of at most ``max_norm``;
    (grads, norm). The scale stays on the device: no host sync."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = torch.clamp(max_norm / gn.clamp(min=1e-12), max=1.0)
    return {n: g.float() * scale for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_plain(grads: Tensors, m: Tensors, v: Tensors, params: Tensors, *, lr: float,
                bc1: float, bc2: float, b1: float, b2: float, eps: float,
                weight_decay: float) -> Tuple[Tensors, Tensors]:
    """One AdamW step of every leaf of ``params``, in place, from clipped
    ``grads``; returns the new moments (new tensors: ``m`` and ``v`` are only
    read)."""
    new_m, new_v = {}, {}
    for n, p in params.items():
        g = grads[n].float()
        mn = b1 * m[n] + (1 - b1) * g
        vn = b2 * v[n] + (1 - b2) * g.square()
        upd = (mn / bc1) / (torch.sqrt(vn / bc2) + eps)
        if p.ndim >= 2:   # decoupled weight decay on matrices only
            upd = upd + weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        new_m[n], new_v[n] = mn, vn
    return new_m, new_v
