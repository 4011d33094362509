"""Async, crash-safe checkpoints of the model and the optimizer state."""
