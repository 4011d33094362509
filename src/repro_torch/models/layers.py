"""Shared building blocks: norms, RoPE, SwiGLU MLP, seeded init.

Twins of ``repro/models/layers.py``. Weights keep the reference's
orientation, (in, out), so ``x @ w`` is the reference's
``einsum("...m,mf->...f", x, w)``.
"""

from __future__ import annotations

import math
from typing import Tuple

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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale for a context ``factor`` times the original."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(dim: int, cfg) -> Tuple[int, int]:
    """(low, high): the rope pairs between which YaRN's ramp runs, from the
    pairs that turn ``yarn_beta_fast`` and ``yarn_beta_slow`` times over the
    original context (DeepSeek-V2's ``yarn_find_correction_range``)."""
    def pair(rotations: float) -> float:
        return (dim * math.log(cfg.yarn_original_max_pos / (rotations * 2 * math.pi))
                / (2 * math.log(cfg.rope_theta)))
    return (max(math.floor(pair(cfg.yarn_beta_fast)), 0),
            min(math.ceil(pair(cfg.yarn_beta_slow)), dim - 1))


def yarn_freqs(dim: int, cfg, device=None) -> torch.Tensor:
    """YaRN's rope frequencies (D/2,): θ^(−2i/D) (extrapolated) below pair
    ``low``, θ^(−2i/D) / factor (interpolated) above ``high``, a linear ramp
    between. Made on the device, so a CUDA graph may capture it."""
    extra = rope_freqs(dim, cfg.rope_theta, device)
    inter = extra / cfg.yarn_factor
    low, high = yarn_range(dim, cfg)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def rope(x: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    """``apply_rope`` by the config: YaRN's frequencies and cos/sin scale
    where ``cfg.yarn_factor`` is set, else the plain rope at ``rope_theta``."""
    if not cfg.yarn_factor:
        return apply_rope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta,
                      freqs=yarn_freqs(x.shape[-1], cfg, x.device),
                      scale=(yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
                             / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)))


def yarn_attn_factor(cfg) -> float:
    """YaRN's factor on attention scores, mscale(factor, mscale_all_dim)²
    where the config sets both; else 1."""
    if not (cfg.yarn_factor and cfg.yarn_mscale_all_dim):
        return 1.0
    return yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2


def softmax_scale(cfg, dim: int) -> float:
    """Attention's score scale over a head dim ``dim``: dim^-0.5, times
    ``yarn_attn_factor``."""
    return dim ** -0.5 * yarn_attn_factor(cfg)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               freqs: torch.Tensor = None, scale: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S). Split-half layout.
    ``freqs`` (D/2,) replaces θ^(−2i/D); cos and sin are multiplied by ``scale``."""
    if freqs is None:
        freqs = rope_freqs(x.shape[-1], theta, x.device)         # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    if x.ndim == angles.ndim + 1:                                # has head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
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
