"""``csrc/flash_attention.cu``'s share of its roofline in prefill, %: each
traced request's calls (one a layer, causal over its prompt) against the
device time of the forward kernels."""

from bench.lib import roofline
from bench.lib.readers import kernel_share

PATTERN = r"flash_attention_(bf16|f32)_kernel"


def read(r):
    m = r.model
    return kernel_share(r, PATTERN, lambda S: m["num_layers"] * roofline.least_s(roofline.flash_fwd(
        1, S, m["num_heads"], m["num_kv_heads"], m["head_dim"], m.get("window"))))
