"""llava-next-34b [vlm] — anyres tiling (hf:llava-hf/llava-v1.6 family).

Backbone only: the vision tower + anyres patchifier are a stub —
``input_specs()`` feeds precomputed patch embeddings (B, S, d_model)."""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    vocab_size=64_000,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    frontend="vision",
)

REDUCED = replace(
    CONFIG, name="llava-reduced", num_layers=2, d_model=128,
    vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
)
