"""The whole prefill's share of the card's peak, %: each untraced request's
least time in the window (its operations at peak, or its bytes) summed,
over the window's host seconds less the traced part's."""

from bench.lib import roofline
from bench.lib.readers import step_share


def read(r):
    return step_share(r, lambda S: roofline.least_s(roofline.prefill(r.model, S)))
