"""Tokens of every training step completed in the window over its seconds (host clock)."""

from bench.lib.readers import window_rate


def read(r):
    return window_rate(r, "train_tokens")
