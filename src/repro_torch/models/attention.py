"""GQA attention: prefill through the flash kernel, decode through the
paged kernel over a device pool of KV pages.

Twin of ``repro/models/attention.py`` for dense GQA. Where the reference
prefills with ``flash_attention_jnp`` and decodes over a dense cache, the
port calls the two kernels that compute the same functions:
``flash_attention_op`` (prefill) and ``paged_attention`` (decode). On CPU
tensors both run their plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention_op
from ..kernels.paged_attention.ops import (count_live_blocks, paged_attention,
                                           plan_blocks)
from ..memory.kv_cache import PageAllocator
from .layers import apply_rope, weight


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        H, Kh, D, M = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
        self.wq = weight(M, H * D, device=device)
        self.wk = weight(M, Kh * D, device=device)
        self.wv = weight(M, Kh * D, device=device)
        self.wo = weight(H * D, M, device=device)
        if cfg.qkv_bias:
            self.bq = weight(H * D, device=device)
            self.bk = weight(Kh * D, device=device)
            self.bv = weight(Kh * D, device=device)


def qkv_proj(p: Attention, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = apply_rope(q.reshape(B, S, H, D), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, Kh, D), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, Kh, D)


def attention_train(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over the whole sequence; returns (y, k, v)."""
    q, k, v = qkv_proj(p, x, cfg, positions)
    out = flash_attention_op(q, k, v, causal=True, window=cfg.window)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p.wo, k, v


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

@dataclass
class DecodePlan:
    """One decode step's indices on the device, shared by every layer."""

    block_start: torch.Tensor   # (B, NB) int32: first page of each block
    block_valid: torch.Tensor   # (B, NB) int32: pages in the block
    lengths: torch.Tensor       # (B,) int32: tokens once this step's is written
    slot: torch.Tensor          # (B,) int32: flat token slot of this step's k/v
    live_blocks: int            # host: most descriptors a sequence needs

    @property
    def positions(self) -> torch.Tensor:
        return (self.lengths - 1)[:, None]


class PagedKVPool:
    """Every layer's KV pages in one device tensor, plus the page tables.

    ``pool`` is (L, P + R − 1, T, 2, Kh, D): ``pool[l]`` is contiguous in
    the paged kernel's (P, T, 2, Kh, D) layout. The R − 1 slack pages are
    allocated once, here, for block copies that read whole R-page blocks.
    Each sequence gets all ``ceil(max_len / T)`` of its pages in one
    ``alloc`` so its pages form contiguous runs and its blocks stay full.
    """

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, *,
                 page_tokens: int = 16, pages_per_block: int = 4,
                 device: torch.device, dtype: torch.dtype = torch.bfloat16) -> None:
        if cfg.window is not None:
            raise NotImplementedError("sliding-window ring caches are not ported")
        T, R = page_tokens, pages_per_block
        per_seq = -(-max_len // T)
        self.page_tokens, self.pages_per_block = T, R
        self.allocator = PageAllocator(batch * per_seq)
        self.page_table = np.array([self.allocator.alloc(per_seq)
                                    for _ in range(batch)], np.int32)
        self.pool = torch.zeros(
            (cfg.num_layers, self.allocator.num_pages + R - 1, T, 2,
             cfg.num_kv_heads, cfg.head_dim), dtype=dtype, device=device)

    @property
    def capacity(self) -> int:
        """Tokens each sequence can hold."""
        return self.page_table.shape[1] * self.page_tokens

    def token_slots(self, positions: np.ndarray) -> np.ndarray:
        """(B, S) token positions → flat slots ``page·T + offset`` of the pool."""
        if positions.max() >= self.capacity or positions.min() < 0:
            raise IndexError(f"positions outside [0, {self.capacity})")
        T = self.page_tokens
        rows = np.arange(self.page_table.shape[0])[:, None]
        return self.page_table[rows, positions // T] * T + positions % T

    def write(self, layer: int, slots: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Store k, v (B, S, Kh, D) at ``slots`` (B, S) of one layer, in place."""
        flat = self.pool[layer].view(-1, *self.pool.shape[3:])   # (P'·T, 2, Kh, D)
        flat[slots] = torch.stack([k, v], dim=2).to(flat.dtype)

    def plan_step(self, cur_index: np.ndarray) -> DecodePlan:
        """Plan the blocks and this step's write slot on the host; one copy up.

        ``cur_index`` (B,) is each sequence's position of the token being
        decoded, i.e. its cached tokens so far. Each sequence holds all its
        pages from the start, so early in decode its last descriptors hold
        no live token: ``live_blocks`` counts only those that do.
        """
        cur = np.asarray(cur_index, np.int64)
        starts, valid = plan_blocks(self.page_table, self.pages_per_block)
        packed = np.concatenate([starts.ravel(), valid.ravel(), cur + 1,
                                 self.token_slots(cur[:, None])[:, 0]])
        dev = torch.from_numpy(packed.astype(np.int32)).to(self.pool.device)
        B, NB = starts.shape
        n = B * NB
        return DecodePlan(dev[:n].view(B, NB), dev[n:2 * n].view(B, NB),
                          dev[2 * n:2 * n + B], dev[2 * n + B:],
                          count_live_blocks(valid, cur + 1, self.page_tokens))


def attention_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                     cache: PagedKVPool, layer: int, plan: DecodePlan
                     ) -> torch.Tensor:
    """x: (B, 1, M). Writes this token's k/v into its page slot, then attends
    over ``lengths = cur + 1`` tokens (the reference's ``kv_pos <= cur``)."""
    B = x.shape[0]
    q, k, v = qkv_proj(p, x, cfg, plan.positions)
    cache.write(layer, plan.slot[:, None], k, v)
    out = paged_attention(q[:, 0], cache.pool[layer], cache.page_table,
                          plan.lengths, pages_per_block=cache.pages_per_block,
                          plan=(plan.block_start, plan.block_valid),
                          live_blocks=plan.live_blocks)
    return out.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ p.wo
