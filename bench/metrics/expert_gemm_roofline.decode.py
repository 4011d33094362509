"""The MoE's grouped expert products' share of their roofline in decode, %:
each traced step's products (three a MoE layer: the touched experts'
weights once, B·top_k rows in and out; ``bench.lib.roofline_moe.expert_products``)
against the device time of the grouped-GEMM kernels ``torch._grouped_mm``
launches on an H100 (CUTLASS's grouped problem shape)."""

from bench.lib import roofline, roofline_moe
from bench.lib.readers import kernel_share

PATTERN = r"GroupProblemShape"


def read(r):
    return kernel_share(r, PATTERN, lambda lengths: roofline.least_s(
        roofline_moe.expert_products(r.model, len(lengths))))
