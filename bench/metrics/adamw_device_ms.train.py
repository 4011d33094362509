"""Device ms a training step of the operations launched inside the
program's ``train.optimizer`` span (clipping and AdamW's update of every
leaf), in the traced part that recorded the host's operations; each
operation is matched to its launch (``bench.lib.spans.device_s``)."""

from bench.lib import spans


def read(r):
    seg = r.host_segment
    return spans.per_unit(seg, spans.device_s(seg), "train.optimizer", scale=1e3)
