"""95th percentile of every gap between consecutive tokens of a turn in the
window, from CUDA events recorded after each decode step."""

from bench.lib.readers import p95


def read(r):
    return p95(r, "itl_ms")
