"""Device ms a training step of the operations launched inside the
program's MoE spans: ``moe.route`` (router, top-k, the pairs' sort),
``moe.experts`` (the grouped products), ``moe.combine`` (gates, the sum back
to each token) and ``moe.backward`` (the dropless layer's own backward), in
the traced part that recorded the host's operations; each operation is
matched to its launch (``bench.lib.spans.device_s``). None where no such
span ran."""

from bench.lib import spans

SPANS = ("moe.route", "moe.experts", "moe.combine", "moe.backward")


def read(r):
    seg = r.host_segment
    by_span = spans.device_s(seg)
    if not by_span or not any(n in by_span for n in SPANS):
        return None
    return sum(spans.per_unit(seg, by_span, n, scale=1e3) or 0.0 for n in SPANS)
