"""command-r-35b [dense] — GQA kv=8, no bias (hf:CohereForAI/c4ai-command-r-v01)."""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    vocab_size=256_000,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_528,
    qkv_bias=False,
)

REDUCED = replace(
    CONFIG, name="command-r-reduced", num_layers=2, d_model=128,
    vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
)
