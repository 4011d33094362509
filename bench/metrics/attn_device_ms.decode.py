"""Device ms a decode step of the operations launched inside the program's
``layer.attn`` spans (projections, RoPE, the cache write, attention over
the cache), in the traced part that recorded the host's operations; each
operation is matched to its launch (``bench.lib.spans.device_s``)."""

from bench.lib import spans


def read(r):
    seg = r.host_segment
    return spans.per_unit(seg, spans.device_s(seg), "layer.attn", scale=1e3)
