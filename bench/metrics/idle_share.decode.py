"""Share of the window's untraced host time in which nothing ran on the
device, %: the traced part's device-busy seconds, scaled by each unit's
least time to the untraced units' work, over their host seconds (see
``bench.lib.readers.idle_share``)."""

from bench.lib import roofline
from bench.lib.readers import idle_share


def read(r):
    return idle_share(r, lambda lengths: roofline.least_s(roofline.decode_step(r.model, lengths)))
