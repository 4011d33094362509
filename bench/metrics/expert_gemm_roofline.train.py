"""The MoE's grouped expert products' share of their roofline in training,
%: each traced step's nine products a MoE layer, forward and backward, over
B·S·top_k rows (``bench.lib.roofline_moe_train.expert_products``), against
the device time of the grouped-GEMM kernels ``torch._grouped_mm`` launches
on an H100 (CUTLASS's grouped problem shape), forward and backward."""

from bench.lib import roofline_moe_train
from bench.lib.readers import kernel_share

PATTERN = r"GroupProblemShape"


def read(r):
    t = r.traffic
    work = roofline_moe_train.expert_products_s(r.model, t["batch"], t["seq"])
    return kernel_share(r, PATTERN, lambda _: work)
