"""Work request / completion descriptors — the RDMA verbs data model.

Terminology follows the paper (§2): a WorkRequest (WR) describes one RDMA
I/O; merged/chained WRs become TransferDescriptors; the NIC reports
WorkCompletions (WC) into CompletionQueues.

Addresses are *page granular*: ``remote_addr`` is a page index within the
destination node's donated region and ``num_pages`` the run length. This is
exactly the granularity of the paper's remote paging system (block I/O size
= fragmentation size, §5.1).
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

PAGE_SIZE = 4096  # bytes per page (paper: block I/O sized; 4 KiB default)

_wr_counter = itertools.count()


class Verb(enum.Enum):
    READ = "read"
    WRITE = "write"


class RegMode(enum.Enum):
    """Memory-region strategy (§5.1, Fig. 4).

    PRE_MR: copy payload into a pre-allocated, pre-registered staging
        buffer (memcpy cost, no registration cost).
    DYN_MR: register the caller's buffer dynamically (registration cost,
        no copy).
    AUTO: threshold switch — dynMR above the crossover size, preMR below
        (the paper's user-space recommendation; kernel space is always
        DYN_MR).
    """

    PRE_MR = "preMR"
    DYN_MR = "dynMR"
    AUTO = "auto"


@dataclass
class WorkRequest:
    """One page-granular RDMA I/O request."""

    verb: Verb
    dest_node: int
    remote_addr: int          # page index at the destination
    num_pages: int = 1
    payload: Any = None       # client buffer: a uint8 torch tensor (view)
    signaled: bool = True
    wr_id: int = field(default_factory=lambda: next(_wr_counter))
    enqueue_time: float = 0.0         # real seconds (perf_counter)
    callback: Optional[Callable[["WorkCompletion"], None]] = None
    # CUDA event recorded on the submitting thread's stream when the
    # payload lies on the card: the NIC's copy is ordered after it
    ready: Any = None

    @property
    def nbytes(self) -> int:
        return self.num_pages * PAGE_SIZE

    @property
    def end_addr(self) -> int:
        return self.remote_addr + self.num_pages


@dataclass
class TransferDescriptor:
    """What actually gets posted to the NIC.

    ``requests`` is the list of original WRs this descriptor carries.
    A descriptor with ``merged=True`` is one WQE covering a contiguous
    remote range (batching-on-MR); ``chained=True`` marks membership of a
    doorbell chain (the first element pays the MMIO, the rest are fetched
    by NIC DMA-read).
    """

    verb: Verb
    dest_node: int
    remote_addr: int
    num_pages: int
    requests: List[WorkRequest]
    merged: bool = False
    chained: bool = False
    reg_mode: RegMode = RegMode.DYN_MR
    sge_count: int = 1        # scatter-gather entries (dynMR merge uses >1)

    @property
    def nbytes(self) -> int:
        return self.num_pages * PAGE_SIZE


class WCStatus(enum.Enum):
    SUCCESS = 0
    FLUSH_ERR = 1
    REMOTE_ERR = 2
    RETRY_EXC_ERR = 3     # transport retries exhausted — peer crashed/unreachable
    RNR_RETRY_ERR = 4     # receiver-not-ready — transient, retry may succeed
    # the host could not move the bytes (a failed device copy, a bad
    # client buffer): not a remote fault, so the completion carries the
    # exception and the future raises it as itself
    LOCAL_ERR = 5


@dataclass
class WorkCompletion:
    wr_id: int
    verb: Verb
    dest_node: int
    nbytes: int
    status: WCStatus = WCStatus.SUCCESS
    post_vtime_us: float = 0.0        # virtual time when posted to NIC
    complete_vtime_us: float = 0.0    # virtual time when NIC finished
    post_rtime: float = 0.0           # real perf_counter at post
    complete_rtime: float = 0.0       # real perf_counter at completion
    requests: List[WorkRequest] = field(default_factory=list)
    # ECN-style congestion mark: the largest fault/congestion multiplier
    # active on any leg of this transfer's path (1.0 = clean path). Lets
    # admission policies react to explicit fabric state instead of
    # inferring it from latency alone.
    ecn_mult: float = 1.0
    error: Optional[BaseException] = None     # set with LOCAL_ERR

    @classmethod
    def for_descriptor(cls, desc: "TransferDescriptor", status: "WCStatus", *,
                       post_v: float, complete_v: float, post_r: float,
                       ecn_mult: float = 1.0,
                       error: Optional[BaseException] = None
                       ) -> "WorkCompletion":
        """The one construction point for NIC completion paths (client-side,
        donor-served, donor-failed): every WC derived from a posted
        descriptor is built here, so a new WC field cannot silently diverge
        across the three paths again."""
        return cls(
            wr_id=desc.requests[0].wr_id if desc.requests else -1,
            verb=desc.verb,
            dest_node=desc.dest_node,
            nbytes=desc.nbytes,
            status=status,
            post_vtime_us=post_v,
            complete_vtime_us=complete_v,
            post_rtime=post_r,
            complete_rtime=time.perf_counter(),
            requests=desc.requests,
            ecn_mult=ecn_mult,
            error=error,
        )

    @property
    def ecn(self) -> bool:
        """True when the fabric marked this completion as congested."""
        return self.ecn_mult > 1.0

    @property
    def latency_us(self) -> float:
        """Virtual-clock completion latency in microseconds."""
        return self.complete_vtime_us - self.post_vtime_us


def contiguous_runs(requests: List[WorkRequest]) -> List[List[WorkRequest]]:
    """Group WRs into maximal runs that are adjacent in remote memory.

    Two requests merge when they target the same destination node, use the
    same verb, and their page ranges abut — i.e. they would land on
    virtually contiguous remote memory (§5.1 "Batching-on-MR"). Input order
    is not assumed sorted; we sort by (node, verb, addr), which is what the
    merge queue's merge-check does.
    """
    if not requests:
        return []
    ordered = sorted(requests, key=lambda r: (r.dest_node, r.verb.value, r.remote_addr))
    runs: List[List[WorkRequest]] = [[ordered[0]]]
    for req in ordered[1:]:
        prev = runs[-1][-1]
        if (
            req.dest_node == prev.dest_node
            and req.verb == prev.verb
            and req.remote_addr == prev.end_addr
        ):
            runs[-1].append(req)
        else:
            runs.append([req])
    return runs


class AtomicCounter:
    """Small thread-safe counter used throughout the engine's stats."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value
