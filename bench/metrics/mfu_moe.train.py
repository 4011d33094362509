"""The whole training step's share of the card's peak for a DeepSeek-V2
decoder, %: each untraced step's least time in the window (its operations
at their peaks, or its parameters', gradients' and AdamW state's bytes:
``bench.lib.roofline_moe_train.train_step``) summed, over the window's host
seconds less the traced part's."""

from bench.lib import roofline, roofline_moe_train
from bench.lib.readers import step_share


def read(r):
    t = r.traffic
    work = roofline.least_s(roofline_moe_train.train_step(r.model, t["batch"], t["seq"]))
    return step_share(r, lambda _: work)
