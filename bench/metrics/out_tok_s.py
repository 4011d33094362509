"""Generated tokens completed in the window over the window's seconds (host clock)."""

from bench.lib.readers import window_rate


def read(r):
    return window_rate(r, "out_tokens")
