"""rdmabox-paper-100m — the ~100M-param model of the end-to-end
training example (examples/train_lm.py), sized so a few hundred steps run
on a CPU while exercising the full substrate (offload engine,
checkpointing, data pipeline)."""

from .base import ModelConfig, replace

CONFIG = ModelConfig(
    name="rdmabox-paper-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    vocab_size=32_000,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
)

REDUCED = replace(
    CONFIG, name="rdmabox-paper-reduced", num_layers=2, d_model=128,
    vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
)
