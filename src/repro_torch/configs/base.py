"""Model config dataclass: a copy of ``repro/configs/base.py``'s ``ModelConfig``.

The port keeps its own copy (it may import nothing from ``repro``); the
tests hold the two field-for-field equal for every ported arch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---------------------------------------------------------
    mixer: str = "attn"              # attn | ssm | hybrid (parallel attn+ssm)
    attention: str = "gqa"           # gqa | mla | none
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    window: Optional[int] = None     # sliding-window size (None = full causal)
    rope_theta: float = 10_000.0
    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # --- FFN ----------------------------------------------------------------
    d_ff: int = 0                    # dense FFN hidden (0 = no dense FFN)
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # --- SSM (Mamba-2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # --- perf knobs of the reference (kept so configs compare equal) --------
    attn_q_block: int = 512
    attn_kv_block: int = 512
    flash_bf16: bool = False
    swa_sliced_kv: bool = False
    moe_shard_map: bool = False
    mla_latent_psum: bool = False
    # --- misc ------------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: Optional[str] = None   # audio|vision: stubbed modality frontend
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()
    notes: str = ""

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128, as the reference pads it."""
        return -(-self.vocab_size // 128) * 128

    @property
    def uses_attention(self) -> bool:
        return self.mixer in ("attn", "hybrid") and self.attention != "none"

    @property
    def uses_ssm(self) -> bool:
        return self.mixer in ("ssm", "hybrid")

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
