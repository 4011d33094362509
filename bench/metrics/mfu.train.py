"""The whole training step's share of the card's peak, %: each untraced
step's least time in the window (forward and backward operations at their
peaks, or the parameters', gradients' and AdamW state's bytes) summed, over
the window's host seconds less the traced part's."""

from bench.lib import roofline
from bench.lib.readers import step_share


def read(r):
    t = r.traffic
    work = roofline.least_s(roofline.train_step(r.model, t["batch"], t["seq"]))
    return step_share(r, lambda _: work)
