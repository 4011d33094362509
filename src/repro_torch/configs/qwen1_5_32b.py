"""qwen1.5-32b [dense] — MHA-style GQA kv=40, QKV bias (hf:Qwen/Qwen1.5-0.5B family)."""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    vocab_size=152_064,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27_392,
    qkv_bias=True,
)

REDUCED = replace(
    CONFIG, name="qwen1.5-32b-reduced", num_layers=2, d_model=128,
    vocab_size=512, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
)
