"""The optimizer: AdamW with a warmup-cosine schedule (``adamw``)."""
