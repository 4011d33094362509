"""The whole decode step's share of the card's peak, %: each untraced step's
least time in the window (its weights, live K/V and SSM state moved once,
or its operations at peak, whichever is longer) summed, over the window's
host seconds less the traced part's."""

from bench.lib import roofline
from bench.lib.readers import step_share


def read(r):
    return step_share(r, lambda lengths: roofline.least_s(roofline.decode_step(r.model, lengths)))
