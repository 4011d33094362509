"""Mixture-of-Experts with sort-based capacity dispatch.

Twin of ``repro/models/moe.py``. Tokens are routed top-k, their gates
renormalised, the (token, expert) pairs stably sorted by expert and packed
into per-expert buffers of capacity ``C`` (pairs past an expert's capacity
go to a trash row and are dropped), the experts run as batched SwiGLU
products over (E, C, M), and each kept pair's output is scatter-added back
to its token in f32, weighted by its gate. Shared experts are one dense
SwiGLU of width ``num_shared_experts · moe_d_ff``.

The reference's ``_moe_shard_map`` (shard-local dispatch over a device
mesh) becomes this single-device dispatch: ``cfg.moe_shard_map`` is a
config field the port keeps so configs compare equal, and ignores. The
expert products are plain batched products in the reference too, outside
any Pallas kernel, so here they stay torch products. Every step stays on
the device: no host sync.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import swiglu, weight


class MoE(nn.Module):
    """The reference's ``init_moe`` leaves, under its names: ``router`` (f32),
    ``wi``/``wg`` (E, M, F), ``wo`` (E, F, M) and the ``shared_*`` SwiGLU."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        M, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        self.router = weight(M, E, device=device, dtype=torch.float32)
        self.wi = weight(E, M, Fe, device=device)
        self.wg = weight(E, M, Fe, device=device)
        self.wo = weight(E, Fe, M, device=device)
        if cfg.num_shared_experts:
            Fs = cfg.num_shared_experts * Fe
            self.shared_wi = weight(M, Fs, device=device)
            self.shared_wg = weight(M, Fs, device=device)
            self.shared_wo = weight(Fs, M, device=device)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert buffer rows: the reference's ``_capacity``."""
    cap = int(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def _dispatch(xt: torch.Tensor, p: MoE, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_dispatch_core`` over all E experts: xt (T, M) → (y (T, M) f32, aux)."""
    T, M = xt.shape
    E, K = cfg.num_experts, cfg.top_k
    dev = xt.device

    probs = torch.softmax(xt.float() @ p.router.float(), dim=-1)     # (T, E)
    gate, expert_idx = torch.topk(probs, K, dim=-1)                   # (T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    # load-balancing aux loss (Switch-style)
    flat_e = expert_idx.reshape(-1)                                   # (T·K,)
    ones = torch.ones(T * K, device=dev)
    ce = torch.zeros(E, device=dev).index_add_(0, flat_e, ones) / (T * K)
    aux = cfg.router_aux_weight * E * torch.sum(probs.mean(dim=0) * ce)

    # sort-based dispatch: row E·C is the trash row of dropped pairs
    C = capacity(T, cfg)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[sorted_e]
    valid = rank < C
    slot = torch.where(valid, sorted_e * C + rank, E * C)
    token_of = order // K

    src = torch.zeros(E * C + 1, dtype=torch.long, device=dev)
    src[slot] = token_of
    occupied = torch.zeros(E * C + 1, dtype=torch.bool, device=dev)
    occupied[slot] = valid
    src, occupied = src[:-1], occupied[:-1]

    grouped = (xt[src] * occupied[:, None].to(xt.dtype)).view(E, C, M)
    h = torch.bmm(grouped, p.wi)
    g = torch.bmm(grouped, p.wg)
    yg = torch.bmm(h * F.silu(g), p.wo).view(E * C, M)

    w_slot = torch.where(valid, gate.reshape(-1)[order], 0.0)
    w_of_slot = torch.zeros(E * C + 1, device=dev)
    w_of_slot[slot] = w_slot
    w_of_slot = w_of_slot[:-1]
    y = torch.zeros((T, M), dtype=torch.float32, device=dev).index_add_(
        0, src, yg.float() * w_of_slot[:, None] * occupied[:, None])
    return y, aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, M) → (out in x's dtype, aux loss f32 scalar)."""
    B, S, M = x.shape
    xt = x.reshape(B * S, M)
    y, aux = _dispatch(xt, p, cfg)
    if cfg.num_shared_experts:
        y = y + swiglu(xt, p.shared_wi, p.shared_wg, p.shared_wo).float()
    return y.reshape(B, S, M).to(x.dtype), aux
