"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512 + MoE (arXiv:2405.04434).

27L d_model=2048, 16 heads, MoE 64 routed experts top-6 + 2 shared,
expert d_ff=1408. (The assignment line lists both "64e top-6" and
"160 routed"; 64/top-6/2-shared matches V2-*Lite* — we follow the Lite
numbers. Real V2-Lite's dense first layer is homogenized to MoE for
scan-over-layers; noted in DESIGN.md.) MLA: qk_nope 128, qk_rope 64,
v_head 128 ⇒ decode cache = 576 floats/token.

``CONFIG`` is the reference's twin. ``PUBLISHED`` is the model as released
(hf:deepseek-ai/DeepSeek-V2-Lite, config.json), through the port's own
fields: layer 0 a dense SwiGLU of 10,944 (``first_dense_layers`` 1), the
other 26 the MoE with gates as the softmax router gives them
(``norm_topk_prob`` false, ``routed_scaling_factor`` 1), served dropless,
YaRN rope (factor 40 over 4,096 original positions, β 32 and 1, mscale and
mscale_all_dim 0.707), RMSNorm eps 1e-6. 15.71 B parameters, 2.45 B active
a token besides the embedding table.

``STAGE`` is ``PUBLISHED`` cut to one pipeline stage for training: the dense
layer and the first four MoE layers (one whole period and the floor of four
after it), the embedding and the head, with the release's sequence-wise
balance loss (``moe_seq_aux``, α = ``router_aux_weight`` 0.001). 2.840 B
parameters, 623 M active a token. ``STAGE_REDUCED`` is its small twin for the
CPU (``REDUCED``'s widths, the published structure). Neither is in
``registry.ARCH_IDS``, the reference's list; ``registry.get_config`` names
them ``deepseek-v2-lite-5l``.
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

PUBLISHED = replace(
    CONFIG, d_ff=10_944, first_dense_layers=1, norm_topk_prob=False, moe_dropless=True,
    norm_eps=1e-6, yarn_factor=40.0, yarn_original_max_pos=4096, yarn_beta_fast=32.0,
    yarn_beta_slow=1.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707,
    sharding_overrides=(),
)

STAGE = replace(PUBLISHED, name="deepseek-v2-lite-5l", num_layers=5, moe_seq_aux=True)

STAGE_REDUCED = replace(
    REDUCED, name="deepseek-v2-lite-5l-reduced", d_ff=256, first_dense_layers=1,
    norm_topk_prob=False, moe_dropless=True, moe_seq_aux=True, norm_eps=1e-6,
    yarn_factor=40.0, yarn_original_max_pos=4096, yarn_beta_fast=32.0, yarn_beta_slow=1.0,
    yarn_mscale=0.707, yarn_mscale_all_dim=0.707, sharding_overrides=(),
)
