"""``csrc/flash_attention_bwd.cu``'s share of its roofline in training, %:
each traced step's calls (one a layer, pairs inside the window only)
against the device time of its three kernels (Δ, dK/dV, dQ)."""

from bench.lib import roofline
from bench.lib.readers import kernel_share

PATTERN = r"flash_bwd_"


def read(r):
    m, t = r.model, r.traffic
    work = roofline.flash_bwd(t["batch"], t["seq"], m["num_heads"], m["num_kv_heads"],
                              m["head_dim"], m.get("window"))
    return kernel_share(r, PATTERN, lambda _: m["num_layers"] * roofline.least_s(work))
