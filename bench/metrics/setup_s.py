"""Process start to the first timed operation: weights drawn, caches built,
every shape of the cell warmed up (and, in a checkout's first run, the
kernels built)."""

import math


def read(r):
    return r.setup_s if math.isfinite(r.setup_s) else None
