"""Multi-head Latent Attention (DeepSeek-V2): prefill through the flash
kernel, absorbed decode over a compressed latent cache.

Twin of ``repro/models/mla.py``. The decode cache keeps only the low-rank
latent ``c_kv`` (kv_lora_rank) and the decoupled RoPE key ``k_pe`` a token
(576 values for V2-Lite, against 16 heads × 2 × 128). Prefill expands the
latent to per-head keys and values and runs ``flash_attention_op`` at head
dim ``qk_nope + qk_rope`` (192 at full width), with V padded up to that
width and sliced back after, as the reference does. Decode attends in the
latent space with W_kb absorbed into the query, in f32: plain products in
the reference and here (no Pallas kernel there). Under ``mla_latent_psum``
(the ``mla_lat`` knob, ``configs/optimized.py``) a step on a mesh places the
absorbed query's latent axis on "model" as the cache's shards are, so the
scores are a partial sum reduced once, as the reference's decode does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import (Shards, flatten, is_dtensor, keep_grad_sharded,
                                    on_local_shards, settle, split_last)
from ..kernels.flash_attention.ops import flash_attention_op
from .attention import NEG_INF, SlotCache, SlotPlan
from .layers import rms_norm, rope, softmax_scale, weight, yarn_attn_factor


class MLA(nn.Module):
    """The reference's ``init_mla`` leaves, under its names."""

    AXES = {"wq": ("embed", "q_flat"), "wkv_a": ("embed", "lora"), "kv_norm": ("lora",),
            "wk_b": ("lora", "q_flat"), "wv_b": ("lora", "q_flat"), "wo": ("q_flat", "embed")}

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        M, H = cfg.d_model, cfg.num_heads
        R, dr, dn, dv = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
        self.wq = weight(M, H * (dn + dr), device=device)     # no q compression (Lite)
        self.wkv_a = weight(M, R + dr, device=device)          # latent + rope key
        self.kv_norm = weight(R, device=device)
        self.wk_b = weight(R, H * dn, device=device)           # up-projections
        self.wv_b = weight(R, H * dv, device=device)
        self.wo = weight(H * dv, M, device=device)


def _mla_qkv(p: MLA, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    H, R, dn = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_dim
    q = split_last(keep_grad_sharded(x @ p.wq), H, dn + cfg.qk_rope_dim)
    q_nope, q_pe = q[..., :dn], rope(q[..., dn:], positions, cfg)
    kv = x @ p.wkv_a
    c_kv = rms_norm(kv[..., :R], p.kv_norm, cfg.norm_eps)
    k_pe = rope(kv[..., R:], positions, cfg)                           # (B, S, dr)
    return q_nope, q_pe, c_kv, k_pe


def mla_train(p: MLA, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal MLA over the whole sequence; returns (y, c_kv, k_pe)."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(p, x, cfg, positions)
    k_nope = split_last(keep_grad_sharded(c_kv @ p.wk_b), H, dn)
    v = split_last(keep_grad_sharded(c_kv @ p.wv_b), H, dv)
    q = torch.cat([q_nope, q_pe], dim=-1)
    m2 = yarn_attn_factor(cfg)
    if m2 != 1.0:                    # YaRN's m²: the kernel scales by (dn + dr)^-0.5 alone
        q = q * m2
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    # pad v's head dim up to the qk dim for the shared flash path, slice after;
    # both on the local shards (torch 2.11's DTensor gives constant_pad_nd's
    # gradient a placement for one mesh dim on a 2-D mesh)
    out = on_local_shards(
        lambda q, k, v: flash_attention_op(q, k, F.pad(v, (0, dn + dr - dv)),
                                           causal=True)[..., :dv],
        (q, k, v), ((0, 2),) * 3, ((0, 2),), batch=B, heads=(H,))
    return flatten(out, 2, 3) @ p.wo, c_kv, k_pe


class LatentCache(SlotCache):
    """Every layer's ``c_kv`` (L, B, max_len, R) and ``k_pe`` (L, B, max_len,
    dr), as the reference's ``init_mla_cache`` stacked on the layer axis."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, *,
                 device: torch.device, dtype: torch.dtype = torch.bfloat16,
                 shards: Optional[Shards] = None) -> None:
        rank = cfg.kv_lora_rank if shards is None else shards.local_heads(cfg.kv_lora_rank)[0]
        super().__init__(cfg.num_layers, batch, max_len, ((rank,), (cfg.qk_rope_dim,)),
                         device=device, dtype=dtype, shards=shards)

    def _check(self, last: int) -> None:
        """Not a ring: a position past ``max_len`` raises."""
        if last >= self.length:
            raise IndexError(f"position {last} outside [0, {self.length})")

    @property
    def c_kv(self) -> torch.Tensor:
        return self.bufs[0]

    @property
    def k_pe(self) -> torch.Tensor:
        return self.bufs[1]


def mla_decode(p: MLA, x: torch.Tensor, cfg: ModelConfig, cache: LatentCache,
               layer: int, plan: SlotPlan) -> torch.Tensor:
    """Absorbed-matmul decode, x: (B, 1, M). Writes this token's latent and
    rope key, then attends over ``s ≤ cur`` in the latent space: scores
    q_nope·W_kb against ``c_kv`` plus q_pe against ``k_pe``, scaled by
    (dn + dr)^-0.5 (times YaRN's m², ``softmax_scale``); the latent output
    goes up through W_vb."""
    B = x.shape[0]
    H, R = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_pe, c_new, kpe_new = _mla_qkv(p, x, cfg, plan.positions)
    on_local_shards(lambda c, k: cache.write_step(layer, plan, c, k),
                    (c_new[:, 0], kpe_new[:, 0]), ((0, 1), (0, None)), (), batch=B,
                    heads=(R,))
    c_kv, k_pe, valid = cache.c_kv[layer], cache.k_pe[layer], plan.valid
    if cache.shards is not None:     # the cache's shards as DTensors: (B, S, R), (B, S, dr)
        c_kv, k_pe, valid = (cache.shards.to_global(t, d, (R,)) for t, d in (
            (c_kv, (0, 2)), (k_pe, (0, None)), (valid, (0, None))))
    c_kv, k_pe = c_kv.float(), k_pe.float()
    wk_b = split_last(p.wk_b, H, dn).float()
    wv_b = split_last(p.wv_b, H, dv).float()
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wk_b)    # absorb W_kb
    if cfg.mla_latent_psum and is_dtensor(c_kv):
        # q_lat's R on "model" like the cache's shards: the scores are a
        # partial sum over R, reduced once as (B, H, S), not a gathered cache
        q_lat = q_lat.redistribute(c_kv.device_mesh, c_kv.placements)
        s = settle(torch.einsum("bhr,bsr->bhs", q_lat, c_kv))
    else:
        s = torch.einsum("bhr,bsr->bhs", q_lat, c_kv)
    s = s + torch.einsum("bhd,bsd->bhs", q_pe[:, 0].float(), k_pe)
    s = s * softmax_scale(cfg, dn + dr)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c_kv)
    out = torch.einsum("bhr,rhd->bhd", o_lat, wv_b)
    return out.reshape(B, 1, H * dv).to(x.dtype) @ p.wo

