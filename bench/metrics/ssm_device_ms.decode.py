"""Device ms a decode step of the operations launched inside the program's
``layer.ssm`` spans (projections, the conv and state update, the gated
norm, the state write), in the traced part that recorded the host's
operations; each operation is matched to its launch
(``bench.lib.spans.device_s``)."""

from bench.lib import spans


def read(r):
    seg = r.host_segment
    return spans.per_unit(seg, spans.device_s(seg), "layer.ssm", scale=1e3)
