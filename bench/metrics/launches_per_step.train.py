"""Device kernels launched per unit of work (decode step, request or train
step) in the traced part: what the host issues for one step."""

from bench.lib.readers import launches_per_unit


def read(r):
    return launches_per_unit(r)
