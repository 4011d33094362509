"""Dense-GQA decoder stack: forward, prefill into the paged pool, decode.

Twin of ``repro/models/transformer.py`` for dense GQA archs. The layer
``scan`` becomes a Python loop over an ``nn.ModuleList``, and the
reference's prompt-length cache plus splice becomes a prefill that writes
each layer's K and V straight into the paged pool.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ModelConfig
from .attention import Attention, PagedKVPool, attention_decode, attention_train
from .layers import MLP, init_weights, rms_norm, weight


class Block(nn.Module):
    """Pre-norm attention + pre-norm SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        self.norm_mixer = weight(cfg.d_model, device=device)
        self.norm_ffn = weight(cfg.d_model, device=device)
        self.attn = Attention(cfg, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda"
                 ) -> None:
        super().__init__()
        if (cfg.mixer != "attn" or cfg.attention != "gqa" or cfg.uses_moe
                or not cfg.d_ff or cfg.frontend):
            raise NotImplementedError(
                f"{cfg.name}: only dense GQA archs are ported (ROADMAP item 9)")
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = weight(cfg.padded_vocab, cfg.d_model, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = weight(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = weight(cfg.d_model, cfg.padded_vocab, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        unembed = self.embed.T if self.cfg.tie_embeddings else self.unembed
        return x @ unembed

    def _trunk(self, tokens: torch.Tensor,
               cache: Optional[PagedKVPool]) -> torch.Tensor:
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(S, device=self.device).expand(B, S)
        slots = None
        if cache is not None:
            pos = np.broadcast_to(np.arange(S), (B, S))
            slots = torch.from_numpy(cache.token_slots(pos).astype(np.int32)
                                     ).to(self.device)
        for layer, blk in enumerate(self.blocks):
            h = rms_norm(x, blk.norm_mixer, cfg.norm_eps)
            y, k, v = attention_train(blk.attn, h, cfg, positions)
            if cache is not None:
                cache.write(layer, slots, k, v)
            x = x + y
            x = x + blk.mlp(rms_norm(x, blk.norm_ffn, cfg.norm_eps))
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) → logits (B, S, padded_vocab)."""
        return self._logits(self._trunk(tokens, None))

    def init_cache(self, batch: int, max_len: int, *, page_tokens: int = 16,
                   pages_per_block: int = 4) -> PagedKVPool:
        return PagedKVPool(self.cfg, batch, max_len, page_tokens=page_tokens,
                           pages_per_block=pages_per_block, device=self.device)

    def prefill(self, tokens: torch.Tensor, cache: PagedKVPool) -> torch.Tensor:
        """Runs the prompt, writes its K/V into ``cache``; last-position logits."""
        return self._logits(self._trunk(tokens, cache)[:, -1])

    def decode_step(self, cache: PagedKVPool, tokens: torch.Tensor,
                    cur_index: np.ndarray) -> torch.Tensor:
        """One token per sequence: tokens (B,) at host positions ``cur_index``
        (B,). Returns logits (B, padded_vocab)."""
        cfg = self.cfg
        plan = cache.plan_step(cur_index)
        x = self.embed[tokens][:, None, :]                      # (B, 1, M)
        for layer, blk in enumerate(self.blocks):
            h = rms_norm(x, blk.norm_mixer, cfg.norm_eps)
            x = x + attention_decode(blk.attn, h, cfg, cache, layer, plan)
            x = x + blk.mlp(rms_norm(x, blk.norm_ffn, cfg.norm_eps))
        return self._logits(x)[:, 0]


def init_transformer(cfg: ModelConfig, *, seed: int = 0,
                     device: str | torch.device = "cuda") -> Transformer:
    """A model with the reference's init rule, drawn from ``seed``."""
    model = Transformer(cfg, device=device)
    init_weights(model, seed=seed)
    return model
