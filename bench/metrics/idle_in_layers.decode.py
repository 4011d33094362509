"""Share of the device's idle seconds, %, whose gap's midpoint falls inside
one of the program's ``layer`` spans (the block, its mixer or its FFN), in
the traced part that recorded the host's operations: how much of the time
the device waits on the host is spent in the layer loop's launches, against
the cache's plan, the head and what runs outside the step."""

from bench.lib import spans


def read(r):
    idle = spans.idle_s(r.host_segment)
    total = sum(idle.values()) if idle else 0.0
    if not total > 0:
        return None
    inside = sum(v for k, v in idle.items() if k == "layer" or k.startswith("layer."))
    return 100.0 * inside / total
