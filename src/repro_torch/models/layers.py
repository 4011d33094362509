"""Shared building blocks: norms, RoPE, SwiGLU MLP, seeded init.

Twins of ``repro/models/layers.py``. Weights keep the reference's
orientation, (in, out), so ``x @ w`` is the reference's
``einsum("...m,mf->...f", x, w)``.
"""

from __future__ import annotations

import torch
from torch import nn

PARAM_DTYPE = torch.bfloat16


def weight(*shape: int, device: torch.device,
           dtype: torch.dtype = PARAM_DTYPE) -> nn.Parameter:
    """An uninitialised inference weight; ``init_weights`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def init_weights(module: nn.Module, *, seed: int) -> None:
    """The reference's init rule, from a torch generator seeded with ``seed``.

    Norm weights (MLA's ``kv_norm`` too) are ones and 1-D biases zeros; the
    SSM's ``A_log`` and ``D`` are ones (``dt_bias`` and ``conv_b`` are 1-D,
    so zeros); ``embed`` is N(0, 1), the SSM's ``conv_w`` N(0, 0.5²); every
    other tensor is N(0, 1) · shape[0]^-0.5 (the MoE's stacked expert
    weights too, whose leading axis is the expert's, as the reference's
    ``param`` scales them). The draws differ from JAX's, so parity tests load
    the reference's weights instead (``convert``). Each draw is scaled in
    place, so the largest tensor's f32 draw is the only temporary: 8.4 GB
    beside command-r-35b's 64.8 GB of bf16 weights, not twice that.
    """
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    scales = {"embed": 1.0, "conv_w": 0.5}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if "norm" in leaf or leaf in ("A_log", "D"):
            p.fill_(1.0)
        elif p.ndim == 1:
            p.zero_()
        else:
            scale = scales.get(leaf, p.shape[0] ** -0.5)
            p.copy_(torch.randn(p.shape, generator=gen, device=dev).mul_(scale))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S). Split-half layout."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    if x.ndim == angles.ndim + 1:                                # has head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    return ((x @ wi) * nn.functional.silu(x @ wg)) @ wo


class MLP(nn.Module):
    AXES = {"wi": ("embed", "ffn"), "wg": ("embed", "ffn"), "wo": ("ffn", "embed")}

    def __init__(self, d_model: int, d_ff: int, *, device: torch.device) -> None:
        super().__init__()
        self.wi = weight(d_model, d_ff, device=device)
        self.wg = weight(d_model, d_ff, device=device)
        self.wo = weight(d_ff, d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.wi, self.wg, self.wo)
