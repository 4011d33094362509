"""Launch-API calls (kernels, copies, fills) a training step inside the
program's ``train.optimizer`` span: the gradients gathered, clipped by
their global norm and AdamW's update of every leaf, in the traced part
that recorded the host's operations."""

from bench.lib import spans


def read(r):
    seg = r.host_segment
    return spans.per_unit(seg, spans.launches(seg), "train.optimizer")
