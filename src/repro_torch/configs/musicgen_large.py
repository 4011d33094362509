"""musicgen-large [audio] — decoder-only over EnCodec tokens (arXiv:2306.05284).

Backbone only: the EnCodec frontend is a stub — ``input_specs()`` feeds
precomputed frame embeddings (B, S, d_model)."""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    vocab_size=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    frontend="audio",
)

REDUCED = replace(
    CONFIG, name="musicgen-reduced", num_layers=2, d_model=128,
    vocab_size=256, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
)
