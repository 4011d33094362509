"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512 + MoE (arXiv:2405.04434).

27L d_model=2048, 16 heads, MoE 64 routed experts top-6 + 2 shared,
expert d_ff=1408. (The assignment line lists both "64e top-6" and
"160 routed"; 64/top-6/2-shared matches V2-*Lite* — we follow the Lite
numbers. Real V2-Lite's dense first layer is homogenized to MoE for
scan-over-layers; noted in DESIGN.md.) MLA: qk_nope 128, qk_rope 64,
v_head 128 ⇒ decode cache = 576 floats/token.
"""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    vocab_size=102_400,
    attention="mla",
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,            # qk_nope + qk_rope (for bookkeeping)
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    d_ff=0,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    sharding_overrides=(("experts", "model"), ("moe_ff", None)),
)

REDUCED = replace(
    CONFIG, name="deepseek-v2-reduced", num_layers=2, d_model=128,
    vocab_size=512, num_heads=4, kv_lora_rank=32, qk_rope_dim=16,
    qk_nope_dim=32, v_head_dim=32, head_dim=48, num_experts=8,
    num_shared_experts=1, top_k=2, moe_d_ff=64,
)
