"""mamba2-780m [ssm] — SSD, attention-free (arXiv:2405.21060).

48L d_model=1536, vocab=50280, ssm_state=128. d_inner = 2·d_model = 3072,
head_dim 64 ⇒ 48 SSM heads. No KV cache, so decode carries the O(1)
(conv, h) state instead of pages.
"""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    vocab_size=50_280,
    mixer="ssm",
    attention="none",
    d_ff=0,
    ssm_state=128,
    ssm_heads=48,
    ssm_head_dim=64,
    ssm_chunk=256,
    notes="attention-free; paged-KV technique N/A (see DESIGN.md)",
)

REDUCED = replace(
    CONFIG, name="mamba2-reduced", num_layers=2, d_model=128,
    vocab_size=512, ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=32,
)
