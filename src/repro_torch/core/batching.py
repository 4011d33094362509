"""Batching policies (§5.1): how drained requests become NIC postings.

``plan(requests)`` turns a drained batch of WorkRequests into
``(descriptors, doorbell)`` posting groups:

* SINGLE       — one WQE per request, one MMIO each.
* DOORBELL     — all requests chained into one doorbell post: 1 MMIO +
                 (N-1) DMA-reads, but still N WQEs (no RDMA-op reduction —
                 the paper's criticism of doorbell-only batching).
* BATCH_ON_MR  — adjacent requests (contiguous remote pages) merged into
                 one WQE each; each merged WQE posted with its own MMIO.
* HYBRID       — BATCH_ON_MR first, then the resulting (possibly
                 non-adjacent) descriptors chained as one doorbell post.
                 RDMAbox's default: fewest WQEs *and* fewest MMIOs.
"""

from __future__ import annotations

import enum
from typing import List, Tuple

from .descriptors import (
    RegMode,
    TransferDescriptor,
    WorkRequest,
    contiguous_runs,
)


class BatchPolicy(enum.Enum):
    SINGLE = "single"
    DOORBELL = "doorbell"
    BATCH_ON_MR = "batch_on_mr"
    HYBRID = "hybrid"


PostGroup = Tuple[List[TransferDescriptor], bool]  # (descs, doorbell?)


def _single_descs(requests: List[WorkRequest], reg: RegMode) -> List[TransferDescriptor]:
    return [
        TransferDescriptor(
            verb=r.verb, dest_node=r.dest_node, remote_addr=r.remote_addr,
            num_pages=r.num_pages, requests=[r], merged=False, reg_mode=reg,
        )
        for r in requests
    ]


def _merged_descs(requests: List[WorkRequest], reg: RegMode) -> List[TransferDescriptor]:
    descs = []
    for run in contiguous_runs(requests):
        head = run[0]
        descs.append(
            TransferDescriptor(
                verb=head.verb,
                dest_node=head.dest_node,
                remote_addr=head.remote_addr,
                num_pages=sum(r.num_pages for r in run),
                requests=run,
                merged=len(run) > 1,
                reg_mode=reg,
                sge_count=len(run) if reg == RegMode.DYN_MR else 1,
            )
        )
    return descs


def resolve_reg_mode(reg: RegMode, num_pages: int, *, kernel_space: bool,
                     crossover_pages: int) -> RegMode:
    """AUTO resolution per Fig. 4: kernel ⇒ dynMR always; user ⇒ threshold."""
    if reg != RegMode.AUTO:
        return reg
    if kernel_space:
        return RegMode.DYN_MR
    return RegMode.DYN_MR if num_pages >= crossover_pages else RegMode.PRE_MR


def plan(policy: BatchPolicy, requests: List[WorkRequest],
         reg: RegMode = RegMode.DYN_MR, *, kernel_space: bool = True,
         crossover_pages: int = 1 << 30) -> List[PostGroup]:
    """Plan posting groups for one drained batch (single destination QP)."""
    if not requests:
        return []

    def _reg(num_pages: int) -> RegMode:
        return resolve_reg_mode(reg, num_pages, kernel_space=kernel_space,
                                crossover_pages=crossover_pages)

    if policy == BatchPolicy.SINGLE:
        descs = _single_descs(requests, RegMode.DYN_MR)
        for d in descs:
            d.reg_mode = _reg(d.num_pages)
        return [([d], False) for d in descs]
    if policy == BatchPolicy.DOORBELL:
        descs = _single_descs(requests, RegMode.DYN_MR)
        for d in descs:
            d.reg_mode = _reg(d.num_pages)
        return [(descs, True)]
    if policy == BatchPolicy.BATCH_ON_MR:
        descs = _merged_descs(requests, RegMode.DYN_MR)
        for d in descs:
            d.reg_mode = _reg(d.num_pages)
        return [([d], False) for d in descs]
    if policy == BatchPolicy.HYBRID:
        descs = _merged_descs(requests, RegMode.DYN_MR)
        for d in descs:
            d.reg_mode = _reg(d.num_pages)
        return [(descs, True)]
    raise ValueError(f"unknown policy {policy}")
