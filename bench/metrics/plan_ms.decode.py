"""Host ms a decode step in the decode cache's ``plan_step`` (the program's
``kv.plan`` span, its self time) in the traced part that recorded the
host's operations: the step's planning of pages, slots and masks on the
host and its one copy up."""

from bench.lib import spans


def read(r):
    seg = r.host_segment
    return spans.per_unit(seg, spans.self_s(seg), "kv.plan", scale=1e3)
