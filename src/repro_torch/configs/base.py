"""Config dataclasses: copies of ``repro/configs/base.py``'s ``ModelConfig``,
``ShapeConfig``, ``SHAPES``, ``RunConfig`` and ``cell_supported``.

The port keeps its own copy (it may import nothing from ``repro``): the
fields, the ``uses_*`` flags, ``d_inner``, ``sub_quadratic``, the analytic
``param_count`` / ``active_param_count``, the four dry-run shapes and the
rule that only a sub-quadratic arch decodes at 524288 tokens. The tests hold
the two field-for-field equal for every arch and the counts equal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


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
    # --- the port's own (PORT_ONLY): a published model as released ----------
    first_dense_layers: int = 0      # leading layers with a dense SwiGLU of d_ff, not the MoE
    norm_topk_prob: bool = True      # renormalise the top-k gates to sum to 1
    moe_dropless: bool = False       # keep every (token, expert) pair: no capacity
    moe_seq_aux: bool = False        # the balance loss per sequence (DeepSeek-V2's seq_aux)
    yarn_factor: float = 0.0         # YaRN rope scaling factor (0: plain rope)
    yarn_original_max_pos: int = 0   # the context the rope was trained at
    yarn_beta_fast: float = 32.0     # rotations where interpolation ends (high freqs kept)
    yarn_beta_slow: float = 1.0      # rotations where it is complete (low freqs interpolated)
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

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

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_heads * self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500K context (SSM / sliding window)?"""
        return self.mixer == "ssm" or (self.mixer == "hybrid") or (
            self.window is not None)

    @property
    def moe_layers(self) -> int:
        """Layers whose FFN is the MoE: all of them, or those after
        ``first_dense_layers`` (whose FFN is a SwiGLU of ``d_ff``)."""
        return max(self.num_layers - self.first_dense_layers, 0) if self.uses_moe else 0

    def is_moe_layer(self, layer: int) -> bool:
        return self.uses_moe and layer >= self.first_dense_layers

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline math). With
        ``first_dense_layers`` those layers count a SwiGLU of ``d_ff`` and the
        rest the MoE alone."""
        c = self
        n = c.vocab_size * c.d_model          # embed
        if not c.tie_embeddings:
            n += c.vocab_size * c.d_model     # unembed
        per_layer = 2 * c.d_model             # 2 rmsnorm
        if c.uses_attention:
            if c.attention == "mla":
                q_dim = c.num_heads * (c.qk_nope_dim + c.qk_rope_dim)
                per_layer += c.d_model * q_dim
                per_layer += c.d_model * (c.kv_lora_rank + c.qk_rope_dim)
                per_layer += c.kv_lora_rank * c.num_heads * (c.qk_nope_dim + c.v_head_dim)
                per_layer += c.num_heads * c.v_head_dim * c.d_model
            else:
                per_layer += c.d_model * c.num_heads * c.head_dim       # Q
                per_layer += 2 * c.d_model * c.num_kv_heads * c.head_dim  # K,V
                per_layer += c.num_heads * c.head_dim * c.d_model       # O
                if c.qkv_bias:
                    per_layer += (c.num_heads + 2 * c.num_kv_heads) * c.head_dim
        if c.uses_ssm:
            d_in = c.d_inner
            per_layer += c.d_model * (2 * d_in + 2 * c.ssm_state * 1)   # x,z,B,C (grouped n_groups=1)
            per_layer += c.d_model * c.ssm_heads                        # dt proj
            per_layer += d_in * c.d_model                               # out proj
            per_layer += 2 * c.ssm_heads                                # A_log, D
        dense = 3 * c.d_model * c.d_ff                                  # swiglu
        moe = 0
        if c.uses_moe:
            moe += c.d_model * c.num_experts                            # router
            moe += c.num_experts * 3 * c.d_model * c.moe_d_ff
            moe += c.num_shared_experts * 3 * c.d_model * c.moe_d_ff
        if c.first_dense_layers and c.uses_moe:
            return (n + c.num_layers * per_layer + (c.num_layers - c.moe_layers) * dense
                    + c.moe_layers * moe)
        return n + c.num_layers * (per_layer + dense + moe)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared only)."""
        if not self.uses_moe:
            return self.param_count()
        c = self
        full = self.param_count()
        routed_all = c.moe_layers * c.num_experts * 3 * c.d_model * c.moe_d_ff
        routed_active = c.moe_layers * c.top_k * 3 * c.d_model * c.moe_d_ff
        return full - routed_all + routed_active


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    """Training/serving hyperparameters + fault-tolerance knobs."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatch: Optional[int] = None        # grad-accum microbatch (per step)
    remat: str = "none"                     # none | full | dots
    grad_compression: bool = False          # int8 + error feedback all-reduce
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    seed: int = 0


def cell_supported(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch × shape) runnable? long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, ("skipped: pure full-attention arch cannot decode at "
                       "524288 context (quadratic prefill / unbounded KV); "
                       "see DESIGN.md §Arch-applicability")
    return True, ""


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


PORT_ONLY = ("first_dense_layers", "norm_topk_prob", "moe_dropless", "moe_seq_aux",
             "yarn_factor", "yarn_original_max_pos", "yarn_beta_fast", "yarn_beta_slow",
             "yarn_mscale", "yarn_mscale_all_dim")


def shared_fields(cfg: ModelConfig) -> Dict[str, object]:
    """The config's fields that the reference's ``ModelConfig`` also has, as
    ``dataclasses.asdict`` gives them: every field but ``PORT_ONLY``."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in PORT_ONLY}


def port_only_at_defaults(cfg: ModelConfig) -> bool:
    """Whether every ``PORT_ONLY`` field of ``cfg`` is at its default."""
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    return all(getattr(cfg, k) == defaults[k] for k in PORT_ONLY)
