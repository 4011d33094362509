"""The whole decode step's share of the card's peak for a DeepSeek-V2
decoder, %: each untraced step's least time in the window (its weights, the
routed experts its tokens are expected to touch, and the live latent moved
once, or its operations at peak, whichever is longer:
``bench.lib.roofline_moe.decode_step``) summed, over the window's host
seconds less the traced part's."""

from bench.lib import roofline, roofline_moe
from bench.lib.readers import step_share


def read(r):
    return step_share(r, lambda lengths: roofline.least_s(
        roofline_moe.decode_step(r.model, lengths)))
