"""qwen2-moe-a2.7b [moe] — 60 routed top-4 + 4 shared (hf:Qwen/Qwen1.5-MoE-A2.7B).

60 experts do not divide the model axis (16), so expert weights shard on
the per-expert FFN dim instead (TP-inside-expert) — see sharding_overrides.
"""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    vocab_size=151_936,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    qkv_bias=True,
    d_ff=0,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    sharding_overrides=(("experts", None), ("moe_ff", "model")),
)

REDUCED = replace(
    CONFIG, name="qwen2-moe-reduced", num_layers=2, d_model=128,
    vocab_size=512, num_heads=4, num_kv_heads=4, head_dim=32,
    num_experts=6, num_shared_experts=2, top_k=2, moe_d_ff=64,
)
