"""``csrc/ssd_scan_bwd.cu``'s share of its roofline in training, %: each
traced step's calls (one a layer) against the device time of its six
kernels; its f32 work at the TF32 peak, the highest it could run at."""

from bench.lib import roofline
from bench.lib.readers import kernel_share

PATTERN = r"(^|[^\w])g_kernel\(|ssd_bwd_"


def read(r):
    m, t = r.model, r.traffic
    work = roofline.ssd_bwd(t["batch"], t["seq"], m["ssm_heads"], m["ssm_head_dim"],
                            m["ssm_state"], min(m["ssm_chunk"], t["seq"]))
    return kernel_share(r, PATTERN, lambda _: m["num_layers"] * roofline.least_s(work))
