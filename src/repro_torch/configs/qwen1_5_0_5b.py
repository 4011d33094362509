"""qwen1.5-0.5b [dense] — QKV bias (hf:Qwen/Qwen1.5-0.5B)."""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    vocab_size=151_936,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    qkv_bias=True,
)

REDUCED = replace(
    CONFIG, name="qwen1.5-0.5b-reduced", num_layers=2, d_model=128,
    vocab_size=512, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
)
