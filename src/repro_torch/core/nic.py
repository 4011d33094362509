"""Simulated RDMA NIC with the bottlenecks the paper measures.

The cost model captures, in virtual microseconds, the effects RDMAbox
optimizes (§4.1):

* **MMIO vs DMA-read** — posting an unchained WQE costs one MMIO; a
  doorbell chain pays one MMIO for the head and a cheaper DMA-read per
  chained WQE (Kalia et al. 2016).
* **Per-WQE NIC processing** — every WQE costs fixed PU time regardless of
  size; merging N adjacent requests into one WQE (batching-on-MR) removes
  N-1 of these, which doorbell batching alone cannot.
* **WQE-cache thrashing** — while outstanding WQEs exceed the on-NIC cache,
  each additional WQE pays a refetch penalty. This is the I/O-thrashing
  collapse of Fig. 1 and what the admission-control window prevents.
* **Shared wire** — payload bytes serialize on one link; PU fixed costs
  parallelize across ``num_pus`` (multi-QP engages multiple PUs, Fig. 11 —
  gains are sublinear because the wire is shared).
* **preMR/dynMR** — poster-side memcpy vs registration cost with the
  user/kernel asymmetry of Fig. 4.

Timing: virtual time is paced against the real clock (1 vus = ``scale``
real seconds) with debt-based sleeping, so thread-level CPU contention
(e.g. busy polling burning the GIL) degrades throughput the same way NIC
verbs processing degrades under host CPU pressure. Event counts (MMIOs,
WQEs, cache misses, completions) are exact and deterministic.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple, Union

import torch

from .. import resolve_device
from .buffers import worker_stream
from .completion import CompletionQueue
from .descriptors import (
    PAGE_SIZE,
    AtomicCounter,
    RegMode,
    TransferDescriptor,
    Verb,
    WCStatus,
    WorkCompletion,
)
from .hist import LatencyHistogram
from .region import (CacheTier, RegionDirectory, RemoteAccessError,
                     RemoteRegion)

# donor-side service constants: a WRITE-with-imm-style ack is one small
# message on the wire; the DRR quantum is how many bytes one client may be
# served per round before the donor rotates to the next attached client
ACK_BYTES = 64
DRR_QUANTUM_BYTES = 16 * PAGE_SIZE


@dataclass
class ServiceConfig:
    """Donor-side service-plane policy (the ``service`` policy kind).

    ``workers=None`` sizes the worker pool to the cost model's
    ``num_pus`` — one service worker per NIC processing unit, each pinned
    to its own ingress PU pacer so intra-donor service parallelism is
    bounded by the modeled PU count, not by thread count. ``merge`` and
    ``coalesce_acks`` gate the two receive-side batching optimizations
    (the paper's request-merging idea applied to the serve path); both
    are on by default and exist as knobs so their effect is measurable.
    """

    quantum_bytes: int = DRR_QUANTUM_BYTES   # DRR deficit per visit
    merge: bool = True            # drain a deficit's worth as ONE vector
    coalesce_acks: bool = True    # one ack transmit + CQ post per round
    workers: Optional[int] = None  # service workers (None → cost.num_pus)
    # client node -> SLA class name, for per-class serve accounting
    # (``nic.<n>.service.per_class.*``). Filled by the Session from
    # ``ClusterSpec.sla``, never from JSON params; unlisted clients land
    # under "default".
    client_class: Dict[int, str] = field(default_factory=dict)

    def num_workers(self, num_pus: int) -> int:
        return max(1, self.workers if self.workers is not None else num_pus)

    def quantum_for(self, client: int) -> int:
        """Per-visit deficit top-up for ``client`` — plain DRR gives every
        client the same quantum."""
        return self.quantum_bytes

    def visit_offsets(self, order: List[int], start: int,
                      queues: Dict[int, Deque["_DonorJob"]]) -> List[int]:
        """Dispatcher visit plan (serve lock held): absolute positions
        (taken mod ``len(order)``) in the order the DRR scan should try
        clients this pass. Plain DRR visits them round-robin from the
        rotation pointer."""
        return list(range(start, start + len(order)))


@dataclass
class SLOServiceConfig(ServiceConfig):
    """SLA-aware donor dispatch (the ``slo`` service policy).

    Same DRR plane, worker pool, merging, and single-run-per-client
    ordering invariant as :class:`ServiceConfig` — only two decisions
    change, both driven by the clients' SLA classes:

    * **weighted quanta** — a client's per-visit deficit top-up is
      ``quantum_bytes * weight``, so premium queues drain more bytes per
      rotation and bank affordability for large WQEs sooner;
    * **deadline-aware visit order** — each pass visits backlogged
      clients by (priority desc, head-job deadline asc, rotation order),
      where a head job's deadline is its post stamp plus the class's
      ``p99_target_us``. Under backlog the premium queue is tried first
      — i.e. skipped *last* — while classes without a target fall back
      to pure priority-then-rotation order.

    The per-client maps are compiled by the Session from
    ``ClusterSpec.sla``; JSON params never carry them.
    """

    client_weight: Dict[int, float] = field(default_factory=dict)
    client_priority: Dict[int, int] = field(default_factory=dict)
    client_deadline_us: Dict[int, float] = field(default_factory=dict)

    def quantum_for(self, client: int) -> int:
        w = self.client_weight.get(client, 1.0)
        return max(PAGE_SIZE, int(self.quantum_bytes * w))

    def visit_offsets(self, order: List[int], start: int,
                      queues: Dict[int, Deque["_DonorJob"]]) -> List[int]:
        n = len(order)

        def key(pos: int):
            client = order[pos % n]
            q = queues.get(client)
            deadline = float("inf")
            target = self.client_deadline_us.get(client)
            if q and target is not None:
                deadline = q[0].post_v + target
            return (-self.client_priority.get(client, 0), deadline,
                    (pos - start) % n)

        return sorted(range(start, start + n), key=key)


@dataclass
class NICCostModel:
    """Virtual-microsecond costs. Defaults loosely follow ConnectX-3 FDR."""

    mmio_us: float = 0.30           # CPU MMIO write of one WQE (64B BlueFlame)
    dma_read_us: float = 0.10       # NIC DMA-read of one chained WQE
    wqe_proc_us: float = 0.20       # fixed NIC PU processing per WQE
    cache_miss_us: float = 0.80     # WQE refetch when the WQE cache thrashes
    wire_us_per_page: float = 0.585  # 4 KiB / ~7 GB/s (56 Gb/s FDR)
    completion_dma_us: float = 0.10  # CQE write back to host
    # poster-side memory-region costs (Fig. 4)
    memcpy_us_per_page: float = 0.41     # copy into preMR (~10 GB/s)
    reg_user_base_us: float = 11.35      # dynMR setup, user space (virtual addr)
    reg_user_per_page_us: float = 0.36   # per-page PTE/translation cost
    reg_kernel_us: float = 0.12          # dynMR, kernel space (physical addr)
    wqe_cache_entries: int = 128
    num_pus: int = 4
    # donor-side hot-page cache tier (RDCA-style last mile): a served WQE
    # whose pages ALL hit the tier pays this reduced PU charge instead of
    # wqe_proc_us, and its pages pay NO region-bandwidth (wire) charge —
    # the bytes never leave the SmartNIC/LLC-resident mirror
    cache_hit_proc_us: float = 0.05

    def reg_cost_us(self, num_pages: int, kernel_space: bool) -> float:
        if kernel_space:
            return self.reg_kernel_us
        return self.reg_user_base_us + num_pages * self.reg_user_per_page_us

    def memcpy_cost_us(self, num_pages: int) -> float:
        return num_pages * self.memcpy_us_per_page

    def crossover_pages(self) -> int:
        """User-space size above which dynMR beats preMR (paper: ~928 KB)."""
        per_page_gain = self.memcpy_us_per_page - self.reg_user_per_page_us
        if per_page_gain <= 0:
            return 1 << 30
        return int(self.reg_user_base_us / per_page_gain) + 1


class Pacer:
    """Busy-period virtual clock paced against real time.

    ``charge(v_us)`` advances the busy period by ``v_us`` virtual
    microseconds starting no earlier than *now* (idle time is not banked as
    burst credit) and sleeps whenever the virtual clock runs ahead of real
    time by more than the sleep granularity.
    """

    def __init__(self, scale: float, origin: float,
                 min_sleep_real: float = 4e-4):
        self.scale = scale
        self.origin = origin
        self.min_sleep_real = min_sleep_real   # REAL seconds granularity
        self._vtime_us = 0.0  # absolute virtual timestamp of busy-period end
        self._busy_us = 0.0   # total virtual time charged (modeled cost)
        self._lock = threading.Lock()

    def now_us(self) -> float:
        return (time.perf_counter() - self.origin) / self.scale

    @property
    def busy_us(self) -> float:
        """Summed virtual microseconds charged to this resource — the
        modeled cost of the work it did, independent of host-side gaps."""
        with self._lock:
            return self._busy_us

    def charge(self, v_us: float) -> float:
        """Advance the busy period; returns the virtual completion stamp."""
        with self._lock:
            start = max(self._vtime_us, self.now_us())
            self._vtime_us = start + v_us
            end = self._vtime_us
            self._busy_us += v_us
        ahead_real = (end - self.now_us()) * self.scale
        if ahead_real > self.min_sleep_real:
            time.sleep(ahead_real)
        return end


@dataclass
class NICStats:
    mmio_writes: AtomicCounter = field(default_factory=AtomicCounter)
    dma_reads: AtomicCounter = field(default_factory=AtomicCounter)
    wqes_posted: AtomicCounter = field(default_factory=AtomicCounter)
    rdma_ops: AtomicCounter = field(default_factory=AtomicCounter)   # == WQEs
    cache_misses: AtomicCounter = field(default_factory=AtomicCounter)
    completions: AtomicCounter = field(default_factory=AtomicCounter)
    wc_errors: AtomicCounter = field(default_factory=AtomicCounter)
    bytes_on_wire: AtomicCounter = field(default_factory=AtomicCounter)
    memcpy_pages: AtomicCounter = field(default_factory=AtomicCounter)
    registrations: AtomicCounter = field(default_factory=AtomicCounter)
    served_wqes: AtomicCounter = field(default_factory=AtomicCounter)
    acks_sent: AtomicCounter = field(default_factory=AtomicCounter)

    def snapshot(self) -> Dict[str, int]:
        return {
            "mmio_writes": self.mmio_writes.value,
            "dma_reads": self.dma_reads.value,
            "wqes_posted": self.wqes_posted.value,
            "rdma_ops": self.rdma_ops.value,
            "cache_misses": self.cache_misses.value,
            "completions": self.completions.value,
            "wc_errors": self.wc_errors.value,
            "bytes_on_wire": self.bytes_on_wire.value,
            "memcpy_pages": self.memcpy_pages.value,
            "registrations": self.registrations.value,
            "served_wqes": self.served_wqes.value,
            "acks_sent": self.acks_sent.value,
        }


class QueuePair:
    """Send queue bound to one destination node, one CQ, and — when the
    NIC belongs to a fabric — the link to that destination."""

    _counter = 0

    def __init__(self, nic: "SimulatedNIC", dest_node: int, cq: CompletionQueue,
                 link=None):
        QueuePair._counter += 1
        self.qp_id = QueuePair._counter
        self.nic = nic
        self.dest_node = dest_node
        self.cq = cq
        self.link = link
        self.pu_index = self.qp_id % nic.cost.num_pus


@dataclass
class _DonorJob:
    """One transfer handed off to the destination node's NIC for service.

    The client NIC paid the forward leg (poster, PU, egress wire, link);
    the donor pays ingress processing + region bandwidth, moves the bytes,
    and acks back over its *own* egress wire and the reverse link — so a
    slow or congested donor back-pressures every client attached to it.
    """

    desc: TransferDescriptor
    cq: CompletionQueue
    src_node: int                 # the requesting client
    status: WCStatus
    post_v: float
    post_r: float
    fwd_complete_v: float         # forward-leg virtual completion stamp
    fwd_delay_real: float         # forward propagation delay (REAL seconds)
    fwd_mult: float = 1.0         # forward-leg congestion/straggler multiplier
    reg_stall_us: float = 0.0     # MR first-touch registration charge (vus)
    error: Optional[BaseException] = None   # a LOCAL_ERR move's exception


class SimulatedNIC:
    """One node's NIC: PU worker threads + shared wire + WQE cache model.

    When the NIC belongs to a fabric it also *serves* inbound transfers:
    clients hand descriptors to the destination NIC, where a
    deficit-round-robin dispatcher feeds ``service.workers`` service
    workers (each pinned to one ingress PU pacer), so intra-donor service
    parallelism matches the modeled PU count while the shared egress wire
    stays the one honest contention point (see ``_DonorJob``)."""

    def __init__(
        self,
        node_id: int,
        directory: RegionDirectory,
        cost: Optional[NICCostModel] = None,
        scale: float = 1e-6,
        kernel_space: bool = True,
        fabric=None,
        origin: Optional[float] = None,
        service: Optional[ServiceConfig] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.node_id = node_id
        # where the buffers of payload-less reads are allocated: the
        # session's device (client side), never donor memory; without a
        # GPU it raises unless the caller asks for "cpu"
        self.device = resolve_device(device)
        self.directory = directory
        self.cost = cost or NICCostModel()
        self.scale = scale
        self.kernel_space = kernel_space
        # duck-typed Fabric (repro_torch.fabric): provides .link(src, dst),
        # .faults, and .delay; None keeps the standalone single-NIC world
        self._fabric = fabric
        self.stats = NICStats()
        origin = time.perf_counter() if origin is None else origin
        self._origin = origin
        self._wire = Pacer(scale, origin)
        self._pu_pacers = [Pacer(scale, origin) for _ in range(self.cost.num_pus)]
        self._poster_pacer = Pacer(scale, origin)
        self._pu_queues: List[Deque] = [collections.deque()
                                        for _ in range(self.cost.num_pus)]
        self._pu_cv = [threading.Condition() for _ in range(self.cost.num_pus)]
        self._outstanding = AtomicCounter()
        self._running = True
        self._started = False
        self._start_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        # donor-side service plane: per-client job queues, a DRR dispatcher
        # (_next_run_locked), and lazily started service workers
        self.service = service or ServiceConfig()
        self.serve_workers = self.service.num_workers(self.cost.num_pus)
        self._serve_cv = threading.Condition()
        self._serve_queues: Dict[int, Deque[_DonorJob]] = {}
        self._serve_order: List[int] = []
        self._serve_deficit: Dict[int, int] = {}
        self._serve_busy: set = set()   # clients with a run in flight
        self._serve_idx = 0
        self._served: Dict[int, List[int]] = {}    # client -> [ops, bytes]
        self._served_by_worker: List[List[int]] = \
            [[0, 0] for _ in range(self.serve_workers)]
        self._serve_rounds = 0          # dispatch counters (serve_cv held)
        self._merged_runs = 0
        self._merged_jobs = 0
        self._coalesced_acks = AtomicCounter()
        self._coalesced_jobs = AtomicCounter()
        # per-SLA-class serve accounting ([ops, bytes] + service-latency
        # histogram per class name); written by service workers outside
        # the serve lock, so it gets its own small lock
        self._class_lock = threading.Lock()
        self._class_served: Dict[str, List[int]] = {}
        self._class_hist: Dict[str, LatencyHistogram] = {}
        self._serve_threads: List[threading.Thread] = []
        # predictive-MR background prefetch: candidate extents emitted by
        # the MR cache's stride predictor (drained after each served
        # run), picked up ONLY by workers with no dispatchable foreground
        # run. A bounded hint queue — a dropped hint is just a prefetch
        # that never happens, never an error.
        self._prefetch_queue: Deque[Tuple[int, int]] = \
            collections.deque(maxlen=1024)
        self._prefetch_bg_us = 0.0      # background reg time (class lock)

    def _ensure_started(self) -> None:
        """PU worker threads spawn on first post — a fabric full of idle
        donor NICs costs no threads."""
        if self._started:
            return
        with self._start_lock:
            if self._started or not self._running:
                return
            self._threads = [
                threading.Thread(target=self._pu_loop, args=(i,), daemon=True,
                                 name=f"nic{self.node_id}-pu{i}")
                for i in range(self.cost.num_pus)
            ]
            for t in self._threads:
                t.start()
            self._started = True

    # ---- host-facing API -------------------------------------------------
    def create_qp(self, dest_node: int, cq: CompletionQueue) -> QueuePair:
        link = (self._fabric.link(self.node_id, dest_node)
                if self._fabric is not None else None)
        return QueuePair(self, dest_node, cq, link=link)

    def now_us(self) -> float:
        return (time.perf_counter() - self._origin) / self.scale

    def busy_snapshot(self) -> Dict[str, float]:
        """Modeled virtual time (us) charged to each NIC resource. The max
        over resources is the critical-path lower bound for the work done;
        real elapsed over that bound is host-side engine overhead."""
        pu = [p.busy_us for p in self._pu_pacers]
        return {
            "wire_busy_us": self._wire.busy_us,
            "poster_busy_us": self._poster_pacer.busy_us,
            "pu_busy_us": pu,
            "critical_us": max([self._wire.busy_us,
                                self._poster_pacer.busy_us] + pu),
        }

    @property
    def outstanding(self) -> int:
        return self._outstanding.value

    def post(self, qp: QueuePair, descs: List[TransferDescriptor],
             doorbell: bool = False) -> None:
        """Post descriptors; ``doorbell=True`` chains them (1 MMIO total)."""
        if not descs:
            return
        self._ensure_started()
        poster_us = 0.0
        for i, d in enumerate(descs):
            # poster-side MR cost (Fig. 4 path)
            if d.reg_mode == RegMode.PRE_MR:
                poster_us += self.cost.memcpy_cost_us(d.num_pages)
                self.stats.memcpy_pages.add(d.num_pages)
            else:
                poster_us += self.cost.reg_cost_us(d.num_pages, self.kernel_space)
                self.stats.registrations.add(1)
            if doorbell and i > 0:
                d.chained = True
                self.stats.dma_reads.add(1)
            else:
                poster_us += self.cost.mmio_us
                self.stats.mmio_writes.add(1)
            self.stats.wqes_posted.add(1)
            self.stats.rdma_ops.add(1)
        self._poster_pacer.charge(poster_us)
        post_v = self.now_us()
        post_r = time.perf_counter()
        self._outstanding.add(len(descs))
        pu = qp.pu_index
        with self._pu_cv[pu]:
            for d in descs:
                self._pu_queues[pu].append((qp, d, post_v, post_r))
            self._pu_cv[pu].notify()

    @property
    def is_open(self) -> bool:
        return self._running

    def close(self) -> None:
        self._running = False
        for cv in self._pu_cv:
            with cv:
                cv.notify_all()
        with self._serve_cv:
            self._serve_cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        for t in self._serve_threads:
            t.join(timeout=2.0)
        # whatever is still queued (workers never started, or a worker is
        # stuck past its join timeout) fails now — never dropped silently
        with self._serve_cv:
            leftover = [j for q in self._serve_queues.values() for j in q]
            for q in self._serve_queues.values():
                q.clear()
        for j in leftover:
            self._fail_job(j)

    # ---- NIC processing units --------------------------------------------
    def _pu_loop(self, pu: int) -> None:
        cv = self._pu_cv[pu]
        queue = self._pu_queues[pu]
        pacer = self._pu_pacers[pu]
        while True:
            with cv:
                while self._running and not queue:
                    cv.wait(timeout=0.1)
                if not self._running and not queue:
                    return
                qp, desc, post_v, post_r = queue.popleft()
            self._process(pu, pacer, qp, desc, post_v, post_r)

    def _process(self, pu: int, pacer: Pacer, qp: QueuePair,
                 desc: TransferDescriptor, post_v: float, post_r: float) -> None:
        cost = self.cost
        fixed_us = cost.wqe_proc_us
        wire_us = desc.num_pages * cost.wire_us_per_page
        if desc.chained:
            fixed_us += cost.dma_read_us
        # WQE-cache thrash: outstanding beyond cache ⇒ the descriptor is
        # refetched from host memory — a DMA read that consumes the SHARED
        # PCIe/link bandwidth, not just PU time (this is why thrashing
        # collapses throughput even when compute is idle, Fig. 1).
        if self._outstanding.value > cost.wqe_cache_entries:
            wire_us += cost.cache_miss_us
            self.stats.cache_misses.add(1)
        pacer.charge(fixed_us)
        faults = self._fabric.faults if self._fabric is not None else None
        status = (faults.transfer_status(self.node_id, desc.dest_node)
                  if faults is not None else None)
        mult = (faults.wire_multiplier(self.node_id, desc.dest_node)
                if faults is not None else 1.0)
        # Payload (+ refetches) serialize on the shared egress wire; a
        # fabric link adds per-link serialization + propagation delay.
        delay_real = 0.0
        if qp.link is not None:
            complete_v, delay_real = qp.link.transmit(
                self._wire, wire_us, desc.num_pages, desc.nbytes,
                fault_mult=mult)
        else:
            complete_v = self._wire.charge(wire_us * mult)
        self.stats.bytes_on_wire.add(desc.nbytes)
        # When the destination node has its own NIC in the fabric, the
        # transfer is *served* there: the donor moves the bytes and acks
        # back through its own egress + reverse link. Transport-generated
        # errors (peer unreachable) still complete client-side — a dead
        # donor cannot send acks.
        donor_nic = None
        if self._fabric is not None and desc.dest_node != self.node_id \
                and status is not WCStatus.RETRY_EXC_ERR:
            donor_nic = self._fabric.nic_or_none(desc.dest_node)
        if donor_nic is not None:
            # serve_transfer itself fails the job (RETRY_EXC_ERR) when the
            # donor NIC is closed — checked under its lock, so a close
            # racing this handoff can't silently succeed OR hang
            self._outstanding.add(-1)
            donor_nic.serve_transfer(_DonorJob(
                desc=desc, cq=qp.cq, src_node=self.node_id,
                status=status or WCStatus.SUCCESS,
                post_v=post_v, post_r=post_r,
                fwd_complete_v=complete_v, fwd_delay_real=delay_real,
                fwd_mult=mult))
            return
        error = None
        if status is None:          # an error WC, never a silently-dead PU
            with self._copy_scope(desc.requests):
                status, _, _, error = self._move_classified(desc)
        # injected fault (crash / transient): the data never moves
        pacer.charge(cost.completion_dma_us)
        self._outstanding.add(-1)  # one WQE retired
        wc = WorkCompletion.for_descriptor(
            desc, status, post_v=post_v, complete_v=complete_v,
            post_r=post_r, ecn_mult=mult, error=error)
        self.stats.completions.add(1)
        if status != WCStatus.SUCCESS:
            self.stats.wc_errors.add(1)
        if delay_real > 0.0 and self._fabric is not None:
            # propagation delay: deliver later without occupying this PU
            self._fabric.delay.post_at(time.perf_counter() + delay_real,
                                       qp.cq, wc)
        else:
            qp.cq.post(wc)

    @contextlib.contextmanager
    def _copy_scope(self, requests):
        """Run a byte move on this worker thread's own CUDA stream when a
        client buffer lies on the card, after each request's ``ready``
        event (the submitting thread's stream at submit) has passed: the
        host waits for it, so the copies, which keep the interpreter lock
        until they have landed (``buffers.copy_parts``), never wait on
        other work. The region's ``copy_parts`` waits for that stream
        before the stripe locks drop, so a completion posted after the
        move means the bytes have landed. Reads the NIC allocates a buffer
        for get it here, on the current stream, before the move is
        ordered after it. CPU-only moves run as they are."""
        cuda, allocated = None, False
        events = []
        for req in requests:
            if req.verb == Verb.READ and req.payload is None:
                req.payload = torch.empty((req.num_pages, PAGE_SIZE),
                                          dtype=torch.uint8,
                                          device=self.device)
                allocated = True
            if req.ready is not None and req.ready not in events:
                events.append(req.ready)
            if cuda is None and req.payload is not None \
                    and req.payload.is_cuda:
                cuda = req.payload.device
        if cuda is None:
            yield
            return
        stream = worker_stream(cuda)
        if allocated and self.device.type == "cuda":
            stream.wait_stream(torch.cuda.current_stream(cuda))
        for ev in events:
            ev.synchronize()
        with torch.cuda.stream(stream):
            yield

    def _move_classified(self, desc: TransferDescriptor
                         ) -> Tuple[WCStatus, int, int,
                                    Optional[BaseException]]:
        """``_move_data`` with its failure classified: (status, hit pages,
        miss pages, error). A remote access fault is a REMOTE_ERR; any
        other exception is the host's own (a failed device copy), a
        LOCAL_ERR whose exception the client's future raises as itself,
        so paging never takes it for a dead donor."""
        try:
            hits, misses = self._move_data(desc)
        except RemoteAccessError:
            return WCStatus.REMOTE_ERR, 0, desc.num_pages, None
        except Exception as exc:    # a worker must survive it: report it
            return WCStatus.LOCAL_ERR, 0, desc.num_pages, exc
        return WCStatus.SUCCESS, hits, misses, None

    @staticmethod
    def _write_parts(desc: TransferDescriptor) -> List:
        """(page, data) parts of one WRITE descriptor — the ONE place the
        payload-is-None filter lives (shared by the client-side and
        merged donor-side move paths)."""
        return [(req.remote_addr, req.payload)
                for req in desc.requests if req.payload is not None]

    @staticmethod
    def _read_parts(desc: TransferDescriptor) -> List:
        """(page, num_pages, out) parts of one READ descriptor — shared by
        the client-side and merged donor-side move paths (``_copy_scope``
        has allocated the buffers of payload-less requests)."""
        return [(req.remote_addr, req.num_pages, req.payload)
                for req in desc.requests]

    def _move_data(self, desc: TransferDescriptor) -> Tuple[int, int]:
        """Actually move the bytes: one vectorized region access per
        descriptor (single striped-lock round, one ``copy_`` per
        request straight into/out of the caller's buffer — no intermediate
        allocation). Returns (cache-hit pages, miss pages) — writes and
        reads on an uncached region are all misses."""
        region = self.directory.lookup(desc.dest_node)
        if desc.verb == Verb.WRITE:
            region.writev(self._write_parts(desc))
            return 0, desc.num_pages
        parts = self._read_parts(desc)
        hits = sum(self._readv_tiered(region, parts))
        return hits, desc.num_pages - hits

    def _readv_tiered(self, region: RemoteRegion, parts: List) -> List[int]:
        """Gather-read parts through the region's hot-page tier when one
        is attached: fully-resident parts copy out of the mirror (no
        region access), the rest gather from the region in ONE vectorized
        round. Promotion of pages that just crossed the frequency
        threshold happens after the reads (the tier copies them under
        their stripe locks). Returns hit page counts parallel to
        ``parts`` (all zero when no tier is attached)."""
        tier = region.cache
        if tier is None:
            region.readv(parts)
            return [0] * len(parts)
        flags, promote = tier.begin_reads(parts)
        miss = [p for p, f in zip(parts, flags) if not f]
        if miss:
            region.readv(miss)
        hits = [0] * len(parts)
        for k, ((page, n, out), flag) in enumerate(zip(parts, flags)):
            if not flag:
                continue
            if tier.read_into(page, n, out):
                hits[k] = n
            else:       # evicted between classify and serve: same bytes,
                region.readv([(page, n, out)])      # region-served
        for page in promote:
            tier.promote(page)
        return hits

    # ---- donor-side service (fabric mode) --------------------------------
    def serve_transfer(self, job: _DonorJob) -> None:
        """Enqueue an inbound transfer for service by this node's NIC.

        Called by the *requesting* client's NIC. Jobs queue per client;
        a deficit-round-robin dispatcher hands per-client *runs* to
        ``serve_workers`` lazily started service workers, so no attached
        client can starve the others and distinct clients are serviced
        concurrently. A closed NIC fails the job immediately
        (RETRY_EXC_ERR, as if the peer died) instead of leaving the
        client's future hanging."""
        with self._serve_cv:
            if self._running:
                if not self._serve_threads:
                    self._serve_threads = [
                        threading.Thread(
                            target=self._serve_worker, args=(i,),
                            daemon=True,
                            name=f"nic{self.node_id}-serve{i}")
                        for i in range(self.serve_workers)]
                    for t in self._serve_threads:
                        t.start()
                q = self._serve_queues.get(job.src_node)
                if q is None:
                    q = collections.deque()
                    self._serve_queues[job.src_node] = q
                    self._serve_order.append(job.src_node)
                    self._serve_deficit[job.src_node] = 0
                q.append(job)
                self._serve_cv.notify()
                return
        self._fail_job(job)         # closed NIC: fail, don't hang the client

    def _fail_job(self, job: _DonorJob) -> None:
        """Complete a job the donor cannot serve with an error WC — the
        transport-level outcome of a peer that went away mid-transfer."""
        status = job.status if job.status is not WCStatus.SUCCESS \
            else WCStatus.RETRY_EXC_ERR
        wc = WorkCompletion.for_descriptor(
            job.desc, status, post_v=job.post_v,
            complete_v=job.fwd_complete_v, post_r=job.post_r,
            ecn_mult=job.fwd_mult)
        client_nic = (self._fabric.nic_or_none(job.src_node)
                      if self._fabric is not None else None)
        stats = client_nic.stats if client_nic is not None else self.stats
        stats.completions.add(1)
        stats.wc_errors.add(1)
        job.cq.post(wc)

    def _serve_worker(self, wid: int) -> None:
        """One service worker: blocks on the dispatcher, services whole
        per-client runs. Pinned to ONE ingress PU pacer, so a donor's
        service parallelism is bounded by its modeled PU count (one
        worker = one PU's worth of ingress capacity). At most one run per
        client is in flight at a time — a client's jobs are serviced in
        arrival order, as the single serve thread did; parallelism comes
        from servicing DISTINCT clients concurrently."""
        pacer = self._pu_pacers[wid % self.cost.num_pus]
        while True:
            with self._serve_cv:
                while self._running and not self._dispatchable_locked() \
                        and not self._prefetch_queue:
                    self._serve_cv.wait(timeout=0.1)
                if not self._running:
                    # fail whatever is still queued — never drop silently
                    # (every worker drains; the queues are cleared under
                    # the lock, so each job is failed exactly once)
                    leftover = [j for q in self._serve_queues.values()
                                for j in q]
                    for q in self._serve_queues.values():
                        q.clear()
                else:
                    leftover = None
                    # foreground ALWAYS first: background prefetch is
                    # taken only when no foreground run is dispatchable,
                    # so prediction can never steal service capacity
                    # from SLO tenants. (_next_run_locked has deficit
                    # side effects — don't call it unless dispatchable.)
                    run = (self._next_run_locked(wid)
                           if self._dispatchable_locked() else [])
                    prefetch = (self._prefetch_queue.popleft()
                                if not run and self._prefetch_queue
                                else None)
            if leftover is not None:
                for j in leftover:
                    self._fail_job(j)
                return
            if run:
                client = run[0].src_node
                try:
                    self._serve_run(pacer, run)
                finally:
                    with self._serve_cv:
                        self._serve_busy.discard(client)
                        # the client may have more queued jobs that only
                        # this completion made dispatchable
                        self._serve_cv.notify_all()
            elif prefetch is not None:
                self._prefetch_extent(pacer, prefetch)

    def _queue_prefetch(self, extents: List[Tuple[int, int]]) -> None:
        """Queue predicted extents for background registration and wake
        idle workers (foreground-first: a worker only takes one of these
        when no foreground run is dispatchable)."""
        with self._serve_cv:
            if not self._running:
                return
            self._prefetch_queue.extend(extents)
            self._serve_cv.notify_all()

    def _prefetch_extent(self, pacer: Pacer, extent: Tuple[int, int]) -> None:
        """Register one predicted extent in the background: the reg cost
        lands on THIS worker's PU pacer like any ingress work, but only
        idle workers run it — prediction turns a would-be critical-path
        fault into a warm hit without stealing service capacity."""
        region = self.directory.get(self.node_id)
        mrc = getattr(region, "mr", None) if region is not None else None
        reg = getattr(mrc, "prefetch_register", None)
        if reg is None:
            return              # cache detached since the hint was queued
        page, n = extent
        registered = reg(page, n)
        if not registered:
            return              # a demand fault (or prefetch) won the race
        bg_us = self.cost.reg_cost_us(registered, self.kernel_space)
        pacer.charge(bg_us)
        self.stats.registrations.add(1)
        with self._class_lock:
            self._prefetch_bg_us += bg_us

    def _dispatchable_locked(self) -> bool:
        """Worker wake-up predicate (lock held): some non-busy client's
        head job is affordable within one more quantum top-up, OR clients
        are banking deficit and NOTHING is being serviced. The second arm
        keeps a lone jumbo-WQE client progressing (repeated dispatch
        passes bank its deficit, bounded by need/quantum); while other
        runs ARE in flight, banking clients wait for run completions
        instead — idle workers must not spin-feed a jumbo's deficit past
        its per-rotation DRR byte share."""
        banking = False
        for c, q in self._serve_queues.items():
            if not q or c in self._serve_busy:
                continue
            if self._serve_deficit[c] + self.service.quantum_for(c) \
                    >= q[0].desc.nbytes:
                return True
            banking = True
        return banking and not self._serve_busy

    def _next_run_locked(self, wid: int) -> List[_DonorJob]:
        """Deficit-round-robin dispatch across attached clients (lock
        held): visit backlogged clients in the service policy's order
        (plain DRR: round-robin from the rotation pointer; SLO:
        priority/deadline first), top the visited client's deficit up by
        its per-client quantum if lagging, and drain up to a deficit's
        worth of its queue as ONE run (a single job when merging is
        disabled). May return [] while a jumbo WQE is still accumulating
        deficit. A client whose previous run is still in flight is
        skipped — its jobs must be serviced in arrival order, whatever
        the policy. Accounting for the run (per client, per worker, per
        SLA class) happens here, atomically with the dispatch decision."""
        svc = self.service
        n = len(self._serve_order)
        start = self._serve_idx
        selected = None
        for pos in svc.visit_offsets(self._serve_order, start,
                                     self._serve_queues):
            client = self._serve_order[pos % n]
            q = self._serve_queues[client]
            if not q or client in self._serve_busy:
                continue
            if self._serve_deficit[client] < q[0].desc.nbytes:
                self._serve_deficit[client] += svc.quantum_for(client)
            if self._serve_deficit[client] < q[0].desc.nbytes:
                continue                    # keep banking, try next client
            selected = (pos, client, q)
            break
        if selected is None:
            self._serve_idx = start + n     # full pass, nothing ready
            return []
        pos, client, q = selected
        run = [q.popleft()]
        self._serve_deficit[client] -= run[0].desc.nbytes
        if svc.merge:
            while q and self._serve_deficit[client] >= q[0].desc.nbytes:
                job = q.popleft()
                self._serve_deficit[client] -= job.desc.nbytes
                run.append(job)
        # rotate away only when this client's deficit is spent (or its
        # queue drained) — with merge=False a client still holding
        # affordable deficit keeps the pointer, so per-job runs retain
        # the same per-rotation BYTE share as merged runs
        if not q:
            self._serve_deficit[client] = 0    # idle flows bank nothing
            self._serve_idx = pos + 1
        elif self._serve_deficit[client] < q[0].desc.nbytes:
            self._serve_idx = pos + 1
        else:
            self._serve_idx = pos
        nbytes = sum(j.desc.nbytes for j in run)
        served = self._served.setdefault(client, [0, 0])
        served[0] += len(run)
        served[1] += nbytes
        by_worker = self._served_by_worker[wid]
        by_worker[0] += len(run)
        by_worker[1] += nbytes
        self._serve_rounds += 1
        if len(run) > 1:
            self._merged_runs += 1
            self._merged_jobs += len(run)
        self._serve_busy.add(client)
        return run

    def _serve_run(self, pacer: Pacer, jobs: List[_DonorJob]) -> None:
        """Service one per-client run: ONE batched ingress PU charge and
        one region-bandwidth charge for the whole vector, a single
        ``writev``/``readv`` region round, then a coalesced
        WRITE-with-imm-style ack through this node's egress wire and the
        reverse link (one transmit + one batched CQ delivery per round
        instead of per job). Jobs served wholly from the hot-page cache
        tier charge the reduced hit-path cost — per segment, so a merged
        run may mix hits and misses: each fully-hit WQE pays
        ``cache_hit_proc_us`` instead of ``wqe_proc_us``, and only miss
        pages consume region bandwidth."""
        cost = self.cost
        client = jobs[0].src_node
        faults = self._fabric.faults
        mult = faults.serve_multiplier(self.node_id, client)
        self.stats.served_wqes.add(len(jobs))
        # registration-on-demand: with an MR cache attached, every job's
        # extents are classified BEFORE bytes move. A warm extent costs
        # nothing extra; a miss is a first-touch fault — the cache
        # registers the missing pages (charged reg_cost_us on THIS
        # worker's pacer, like any ingress processing) and the job soft-
        # fails RNR_RETRY_ERR so the client's bounded RNR retry machinery
        # replays it against the now-warm (pinned) extent. The faulted
        # job still pays its WQE + wire charge below — the RNR NAK
        # consumed those resources.
        region = self.directory.get(self.node_id)
        mr = getattr(region, "mr", None) if region is not None else None
        if mr is not None:
            reg_us = 0.0
            for job in jobs:
                if job.status is not WCStatus.SUCCESS:
                    continue
                fault, registered = mr.serve(job.desc, client=client)
                if fault:
                    job.status = WCStatus.RNR_RETRY_ERR
                    stall = cost.reg_cost_us(registered, self.kernel_space)
                    job.reg_stall_us = stall * mult
                    reg_us += stall
                    self.stats.registrations.add(1)
            if reg_us:
                pacer.charge(reg_us * mult)
            # predicted extents from this run's stride observations go to
            # the background queue — idle workers register them so the
            # demand stream hits instead of faulting
            drain = getattr(mr, "drain_predictions", None)
            if drain is not None:
                cands = drain()
                if cands:
                    self._queue_prefetch(cands)
        with self._copy_scope([r for j in jobs for r in j.desc.requests]):
            statuses, hit_pages, miss_pages = self._move_run(jobs)
        # ingress processing lands on THIS worker's pacer; donor-region
        # bandwidth stays on the shared wire — the honest contention point.
        # With no tier every job is a miss, reproducing the uncached
        # charges exactly (wqe_proc_us per WQE + wire time per page).
        hit_wqes = sum(1 for h, m in zip(hit_pages, miss_pages)
                       if h and not m)
        pacer.charge((cost.wqe_proc_us * (len(jobs) - hit_wqes)
                      + cost.cache_hit_proc_us * hit_wqes) * mult)
        wire_pages = sum(miss_pages)
        if wire_pages:
            self._wire.charge(wire_pages * cost.wire_us_per_page * mult)
        # ack leg: donor egress + reverse link back to the client
        link = self._fabric.link(self.node_id, client)
        if self.service.coalesce_acks or len(jobs) == 1:
            ack_v, ack_delay = link.transmit(
                self._wire, cost.completion_dma_us, 0, ACK_BYTES,
                fault_mult=mult)
            self.stats.acks_sent.add(1)
            self.stats.bytes_on_wire.add(ACK_BYTES)
            if len(jobs) > 1:
                self._coalesced_acks.add(1)
                self._coalesced_jobs.add(len(jobs))
            acks = [(ack_v, ack_delay)] * len(jobs)
        else:
            acks = [link.transmit(self._wire, cost.completion_dma_us, 0,
                                  ACK_BYTES, fault_mult=mult)
                    for _ in jobs]
            self.stats.acks_sent.add(len(jobs))
            self.stats.bytes_on_wire.add(ACK_BYTES * len(jobs))
        # completion accounting stays with the *client's* NIC — it is the
        # one whose CQ receives the CQEs
        client_nic = self._fabric.nic_or_none(client)
        stats = client_nic.stats if client_nic is not None else self.stats
        errors = 0
        deliveries: List[Tuple[object, WorkCompletion, float]] = []
        latencies: List[float] = []
        for job, status, (ack_v, ack_delay) in zip(jobs, statuses, acks):
            wc = WorkCompletion.for_descriptor(
                job.desc, status, post_v=job.post_v,
                complete_v=max(ack_v, job.fwd_complete_v),
                post_r=job.post_r,
                # mark with the worst leg: forward (client egress + link)
                # or donor service/ack — either degraded is congestion
                ecn_mult=max(job.fwd_mult, mult), error=job.error)
            if status is not WCStatus.SUCCESS:
                errors += 1
                # an MR first-touch fault is a *registration stall*, not
                # a loss: record the NAK's latency inflated by the
                # registration charge into the class histogram, so SLO
                # tenants see the stall in their per-class tail instead
                # of it vanishing into an unrecorded soft error (the
                # replayed job records its own warm-path sample later)
                if job.reg_stall_us > 0.0:
                    latencies.append(wc.latency_us + job.reg_stall_us)
            else:
                latencies.append(wc.latency_us)
            deliveries.append((job.cq, wc, job.fwd_delay_real + ack_delay))
        # per-SLA-class accounting: which class this client belongs to is
        # policy data (service.client_class); successful jobs record
        # their post→ack virtual latency into the class histogram
        cls_name = self.service.client_class.get(client, "default")
        with self._class_lock:
            acc = self._class_served.setdefault(cls_name, [0, 0])
            acc[0] += len(jobs)
            acc[1] += sum(j.desc.nbytes for j in jobs)
            hist = self._class_hist.get(cls_name)
            if hist is None:
                hist = self._class_hist[cls_name] = LatencyHistogram()
        hist.record_many(latencies)
        stats.completions.add(len(jobs))
        if errors:
            stats.wc_errors.add(errors)
        if self.service.coalesce_acks:
            # batched CQ delivery: one post per touched CQ; a shared ack
            # naturally lands the whole group at the slowest job's delay
            by_cq: Dict[object, List] = {}
            for cq, wc, delay in deliveries:
                by_cq.setdefault(cq, []).append((wc, delay))
            for cq, group in by_cq.items():
                wcs = [wc for wc, _ in group]
                delay = max(d for _, d in group)
                if delay > 0.0:
                    self._fabric.delay.post_many_at(
                        time.perf_counter() + delay, cq, wcs)
                else:
                    cq.post_many(wcs)
        else:
            # per-job acks ⇒ per-job delivery at each job's own delay
            for cq, wc, delay in deliveries:
                if delay > 0.0:
                    self._fabric.delay.post_at(
                        time.perf_counter() + delay, cq, wc)
                else:
                    cq.post(wc)

    def _move_run(self, jobs: List[_DonorJob]
                  ) -> Tuple[List[WCStatus], List[int], List[int]]:
        """Move a whole run's bytes in one vectorized region round (one
        ``writev`` + one ``readv`` at most — a single striped-lock
        acquisition per verb). Per-page error isolation: if the merged
        round fails (e.g. one job targets pages outside the region), fall
        back to per-job moves so one bad page fails only its own job, not
        its run-mates. Returns (statuses, per-job cache-hit pages,
        per-job miss pages) — un-moved (fault-injected or failed) jobs
        count as all-miss, preserving the uncached charge for them. Only
        a remote access fault is a REMOTE_ERR; any other exception of a
        job's move is a LOCAL_ERR kept on ``job.error``."""
        statuses = [j.status for j in jobs]
        hit_pages = [0] * len(jobs)
        miss_pages = [j.desc.num_pages for j in jobs]
        live = [i for i, s in enumerate(statuses) if s is WCStatus.SUCCESS]
        if not live:
            return statuses, hit_pages, miss_pages   # fault-injected run
        if len(live) == 1:
            i = live[0]
            statuses[i], hit_pages[i], miss_pages[i], jobs[i].error = \
                self._move_classified(jobs[i].desc)
            return statuses, hit_pages, miss_pages
        # vector rounds are issued in QUEUE order, segmented at verb
        # boundaries, so a READ queued before a WRITE of the same pages
        # still observes the pre-write bytes (a homogeneous burst — the
        # common case — stays one writev or one readv). ``owners`` maps
        # each part back to its job, so a merged run's cache hits are
        # attributed per WQE (a run may mix hit and miss jobs).
        segments: List[Tuple[Verb, List, List[int], List[int]]] = []
        for i in live:
            desc = jobs[i].desc
            if not segments or segments[-1][0] != desc.verb:
                segments.append((desc.verb, [], [], []))
            parts = (self._write_parts(desc) if desc.verb == Verb.WRITE
                     else self._read_parts(desc))
            segments[-1][1].extend(parts)
            segments[-1][2].extend([i] * len(parts))
            segments[-1][3].append(i)
        try:
            region = self.directory.lookup(jobs[live[0]].desc.dest_node)
        except RemoteAccessError:       # no such region: every job fails
            for i in live:
                statuses[i] = WCStatus.REMOTE_ERR
            return statuses, hit_pages, miss_pages
        for verb, parts, owners, idxs in segments:
            try:
                if verb == Verb.WRITE:
                    region.writev(parts)
                else:
                    for owner, h in zip(owners,
                                        self._readv_tiered(region, parts)):
                        if h:
                            hit_pages[owner] += h
                            miss_pages[owner] -= h
            except Exception:
                # one bad page must not fail its run-mates: per-job
                # fallback for THIS segment only, still in queue order —
                # segments already applied are never re-executed, so a
                # read ordered before a later write can't observe it
                for i in idxs:
                    statuses[i], _, _, jobs[i].error = \
                        self._move_classified(jobs[i].desc)
                    hit_pages[i], miss_pages[i] = 0, jobs[i].desc.num_pages
        return statuses, hit_pages, miss_pages

    def fairness_snapshot(self) -> Dict[int, Dict[str, int]]:
        """Per-client donor-side service accounting (empty for NICs that
        never served inbound traffic)."""
        with self._serve_cv:
            return {c: {"ops": v[0], "bytes": v[1]}
                    for c, v in self._served.items()}

    def service_snapshot(self) -> Dict[str, object]:
        """Service-plane accounting: per-worker served WQEs/bytes, DRR
        rounds, the two receive-side batching counters (merged runs,
        coalesced acks), per-SLA-class serve counters + latency
        histograms under ``per_class``, the hot-page cache tier's
        counters under ``cache``, and the MR cache's under ``mr`` (both
        report a zeroed shape when not attached). Lives under
        ``nic.<node>.service.*`` in the session stats tree."""
        from .registration import MRCache     # lazy: registration -> nic
        region = self.directory.get(self.node_id)
        tier = region.cache if region is not None else None
        cache = (tier.snapshot() if tier is not None
                 else CacheTier.disabled_snapshot())
        mrc = getattr(region, "mr", None) if region is not None else None
        mr = (mrc.snapshot() if mrc is not None
              else MRCache.disabled_snapshot())
        with self._serve_cv:
            workers = {str(i): {"served_wqes": w[0], "served_bytes": w[1]}
                       for i, w in enumerate(self._served_by_worker)}
            clients = {c: {"ops": v[0], "bytes": v[1]}
                       for c, v in self._served.items()}
            rounds = self._serve_rounds
            merged_runs = self._merged_runs
            merged_jobs = self._merged_jobs
            pf_queued = len(self._prefetch_queue)
        # queued/bg_pu_us are NIC-side facts the cache can't know — fill
        # them into the cache's prefetch block (zeros stay zeros when
        # prefetch is off, keeping the disabled shape bit-identical)
        pf = mr.get("prefetch")
        if isinstance(pf, dict):
            with self._class_lock:
                pf["queued"] = pf_queued
                pf["bg_pu_us"] = self._prefetch_bg_us
        with self._class_lock:
            per_class = {
                name: {"ops": acc[0], "bytes": acc[1],
                       "latency": self._class_hist[name].snapshot()
                       if name in self._class_hist
                       else LatencyHistogram.empty_snapshot()}
                for name, acc in self._class_served.items()}
        return {
            "serve_workers": self.serve_workers,
            "workers": workers,
            "clients": clients,
            "rounds": rounds,
            "merged_runs": merged_runs,
            "merged_jobs": merged_jobs,
            "coalesced_acks": self._coalesced_acks.value,
            "coalesced_jobs": self._coalesced_jobs.value,
            "per_class": per_class,
            "cache": cache,
            "mr": mr,
        }
