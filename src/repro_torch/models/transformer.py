"""Decoder stack: forward, prefill into the decode cache, decode.

Twin of ``repro/models/transformer.py`` for dense-GQA and SSM archs. A
block is a pre-norm mixer (GQA attention or the Mamba-2 SSM) plus a
pre-norm SwiGLU FFN when ``d_ff`` is set (with ``d_ff = 0`` the FFN half
adds nothing, as in the reference). The layer ``scan`` becomes a Python
loop over an ``nn.ModuleList``. The reference's prompt-length cache plus
splice becomes a prefill that writes each layer's state straight into the
decode cache: K and V into the paged pool for attention, the (conv, h)
state into an ``SSMCache`` for the SSM.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ModelConfig
from .attention import Attention, PagedKVPool, attention_decode, attention_train
from .layers import MLP, init_weights, rms_norm, weight
from .ssm import SSM, SSMCache, ssm_decode, ssm_train

Cache = Union[PagedKVPool, SSMCache]


class Block(nn.Module):
    """Pre-norm mixer (attention or SSM) + pre-norm SwiGLU MLP if ``d_ff``."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        self.norm_mixer = weight(cfg.d_model, device=device)
        self.norm_ffn = weight(cfg.d_model, device=device)
        self.attn = Attention(cfg, device=device) if cfg.uses_attention else None
        self.ssm = SSM(cfg, device=device) if cfg.uses_ssm else None
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device) if cfg.d_ff else None

    def ffn(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        if self.mlp is None:                     # d_ff = 0: the FFN half adds zero
            return x
        return x + self.mlp(rms_norm(x, self.norm_ffn, eps))


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda"
                 ) -> None:
        super().__init__()
        if (cfg.mixer not in ("attn", "ssm") or cfg.attention not in ("gqa", "none")
                or cfg.uses_moe or cfg.frontend):
            raise NotImplementedError(
                f"{cfg.name}: only dense GQA and SSM archs are ported; hybrid, "
                "MLA, MoE and frontend archs are not (ROADMAP item 9)")
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

    def _trunk(self, tokens: torch.Tensor, cache: Optional[Cache]) -> torch.Tensor:
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(S, device=self.device).expand(B, S)
        slots = None
        if cache is not None and cfg.uses_attention:
            pos = np.broadcast_to(np.arange(S), (B, S))
            slots = torch.from_numpy(cache.token_slots(pos).astype(np.int32)
                                     ).to(self.device)
        for layer, blk in enumerate(self.blocks):
            h = rms_norm(x, blk.norm_mixer, cfg.norm_eps)
            if cfg.uses_attention:
                y, k, v = attention_train(blk.attn, h, cfg, positions)
                if cache is not None:
                    cache.write(layer, slots, k, v)
            else:
                y = ssm_train(blk.ssm, h, cfg, return_state=cache is not None)
                if cache is not None:
                    y, state = y
                    cache.write(layer, state)
            x = blk.ffn(x + y, cfg.norm_eps)
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) → logits (B, S, padded_vocab)."""
        return self._logits(self._trunk(tokens, None))

    def init_cache(self, batch: int, max_len: int, *, page_tokens: int = 16,
                   pages_per_block: int = 4) -> Cache:
        """A paged KV pool for attention archs; an ``SSMCache`` (fixed size,
        so ``max_len`` and the page shape do not apply) for SSM archs."""
        if self.cfg.uses_ssm:
            return SSMCache(self.cfg, batch, device=self.device)
        return PagedKVPool(self.cfg, batch, max_len, page_tokens=page_tokens,
                           pages_per_block=pages_per_block, device=self.device)

    def prefill(self, tokens: torch.Tensor, cache: Cache) -> torch.Tensor:
        """Runs the prompt, writes its decode state into ``cache``;
        last-position logits."""
        return self._logits(self._trunk(tokens, cache)[:, -1])

    def decode_step(self, cache: Cache, tokens: torch.Tensor,
                    cur_index: np.ndarray) -> torch.Tensor:
        """One token per sequence: tokens (B,) at host positions ``cur_index``
        (B,). Returns logits (B, padded_vocab)."""
        cfg = self.cfg
        plan = cache.plan_step(cur_index) if cfg.uses_attention else None
        x = self.embed[tokens][:, None, :]                      # (B, 1, M)
        for layer, blk in enumerate(self.blocks):
            h = rms_norm(x, blk.norm_mixer, cfg.norm_eps)
            if cfg.uses_attention:
                y = attention_decode(blk.attn, h, cfg, cache, layer, plan)
            else:
                y = ssm_decode(blk.ssm, h, cache, layer, cfg)
            x = blk.ffn(x + y, cfg.norm_eps)
        return self._logits(x)[:, 0]


def init_transformer(cfg: ModelConfig, *, seed: int = 0,
                     device: str | torch.device = "cuda") -> Transformer:
    """A model with the reference's init rule, drawn from ``seed``."""
    model = Transformer(cfg, device=device)
    init_weights(model, seed=seed)
    return model
