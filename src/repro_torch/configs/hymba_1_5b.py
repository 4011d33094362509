"""hymba-1.5b [hybrid] — parallel attention + Mamba heads (arXiv:2411.13676).

32L d_model=1600, 25 attn heads (GQA kv=5, head_dim 64) in parallel with
SSM heads (d_inner = 2·d_model = 3200 ⇒ 50 heads, state 16). Hymba uses
sliding-window attention in most layers; we model all-SWA (window=1024) +
the SSM global state, which keeps decode sub-quadratic ⇒ long_500k runs.
(Heterogeneous global-attention layers and meta tokens are simplified away
for scan homogeneity; noted in DESIGN.md.)
"""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    vocab_size=32_001,
    mixer="hybrid",
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    window=1024,
    d_ff=5504,
    ssm_state=16,
    ssm_heads=50,
    ssm_head_dim=64,
    ssm_chunk=256,
    notes="all-SWA simplification of Hymba's mixed global/local layers",
)

REDUCED = replace(
    CONFIG, name="hymba-reduced", num_layers=2, d_model=128, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=32, window=64, d_ff=256,
    ssm_state=8, ssm_heads=4, ssm_head_dim=32, ssm_chunk=32,
)
