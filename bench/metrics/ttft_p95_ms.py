"""95th percentile over every request in the window of its time from issue
(before the prompt's copy to the device) to its token, from CUDA events."""

from bench.lib.readers import p95


def read(r):
    return p95(r, "ttft_ms")
