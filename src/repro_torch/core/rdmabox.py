"""RDMABox — the node-level facade (§5, §6).

One object per node wiring together the whole engine:

    merge queue (load-aware batching)  →  batching policy plan
      →  admission window  →  multi-channel post to the NIC
      →  completion queues  →  polling strategy  →  futures/callbacks

``read``/``write`` are page-granular and asynchronous, returning
``TransferFuture``s. ``write_pages``/``read_pages`` are the batched
zero-copy hot path: a whole vector of (page, buffer-view) pairs enters the
merge queue as one pre-formed run under a single lock acquisition and
resolves to ONE ``BatchFuture`` (single event, per-page error map) instead
of N futures. These are the abstractions the remote paging system
(core/paging.py) and the JAX offload tier (memory/offload.py) are built on.

Completion side: the futures table is striped into shard locks keyed by
wr_id, and the poller hands whole WC *lists* to one batched handler, so
admission release and future resolution amortize their lock traffic over
the poll batch instead of paying per completion.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .._deprecation import warn_once
from .admission import AdmissionController, AdmissionHook
from .batching import BatchPolicy, plan
from .buffers import byte_view, ready_event
from .channel import ChannelSet
from .descriptors import (
    PAGE_SIZE,
    AtomicCounter,
    RegMode,
    Verb,
    WCStatus,
    WorkCompletion,
    WorkRequest,
)
from .errors import BoxError, ClosedError
from .hist import LatencyHistogram
from .merge_queue import MergeQueue
from .nic import NICCostModel
from .polling import PollConfig, Poller, PollMode
from .region import RegionDirectory

logger = logging.getLogger(__name__)

# futures-table striping: shard locks keyed by wr_id so concurrent
# submitters/pollers rarely contend on the same lock (power of two)
_FUTURE_SHARDS = 16
_SHARD_MASK = _FUTURE_SHARDS - 1


class TransferError(BoxError):
    """A transfer completed with an error WorkCompletion.

    Carries the failing WC so callers (the paging failover path, retry
    policies) can see *what* failed, not just that something did.
    """

    def __init__(self, wc: WorkCompletion) -> None:
        super().__init__(
            f"RDMA transfer failed: {wc.status.name} "
            f"(wr_id={wc.wr_id}, dest_node={wc.dest_node}, "
            f"verb={wc.verb.value}, nbytes={wc.nbytes})")
        self.wc = wc
        self.status = wc.status
        self.wr_id = wc.wr_id
        self.dest_node = wc.dest_node

    @property
    def transient(self) -> bool:
        """True for statuses where a retry may succeed (RNR-style)."""
        return self.status == WCStatus.RNR_RETRY_ERR


class BatchTransferError(BoxError):
    """One or more pages of a batched transfer failed.

    ``errors`` maps remote page index → ``TransferError``; pages absent
    from the map completed successfully.
    """

    def __init__(self, errors: Dict[int, TransferError]) -> None:
        worst = next(iter(errors.values()))
        super().__init__(
            f"batched RDMA transfer failed on {len(errors)} page(s), "
            f"e.g. page {next(iter(errors))}: {worst.status.name}")
        self.errors = errors


class TransferFuture:
    """Completion future for one WorkRequest."""

    __slots__ = ("_event", "_wc", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._wc: Optional[WorkCompletion] = None
        self._error: Optional[BoxError] = None

    def set(self, wc: WorkCompletion) -> None:
        self._wc = wc
        if wc.error is not None:        # LOCAL_ERR: the host's own failure
            self._error = wc.error
        elif wc.status != WCStatus.SUCCESS:
            self._error = TransferError(wc)
        self._event.set()

    def abort(self, exc: BoxError) -> None:
        """Fail the future without a completion (engine closed mid-flight);
        a waiter is released immediately and ``wait`` raises ``exc``."""
        if self._event.is_set():
            return
        self._error = exc
        self._event.set()

    def resolve(self, req: WorkRequest, wc: WorkCompletion) -> None:
        """Per-request resolution hook shared with ``BatchFuture``."""
        self.set(wc)

    def wait(self, timeout: Optional[float] = None) -> WorkCompletion:
        if not self._event.wait(timeout=timeout):
            raise TimeoutError("RDMA transfer did not complete in time")
        if self._error is not None:
            raise self._error
        assert self._wc is not None
        return self._wc

    def exception(self, timeout: Optional[float] = None) -> Optional[BoxError]:
        """Non-raising accessor for remote outcomes: wait for completion,
        then return the TransferError (or None on success; a ClosedError
        if the engine closed mid-flight). Raises TimeoutError, and the
        exception of a LOCAL_ERR move as itself: a failed device copy is
        not a donor's fault, so the failover paths never see it as one."""
        if not self._event.wait(timeout=timeout):
            raise TimeoutError("RDMA transfer did not complete in time")
        if self._wc is not None and self._wc.error is not None:
            raise self._wc.error
        return self._error

    def completion(self) -> Optional[WorkCompletion]:
        """The WorkCompletion, success or failure; None while in flight."""
        return self._wc

    def done(self) -> bool:
        return self._event.is_set()


class BatchFuture:
    """Completion future for one batched vector of page I/Os.

    One event + one per-page error map for the whole vector — the
    completion-side mirror of batching-on-MR: N pages cost one waiter
    wakeup and one results object, not N events and N futures-dict
    entries. Per-request callbacks (``WorkRequest.callback``) have all
    fired by the time a waiter is released.
    """

    __slots__ = ("_event", "_lock", "_remaining", "_errors", "_aborted",
                 "_local", "pages")

    def __init__(self, num_requests: int) -> None:
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._remaining = num_requests
        self._errors: Dict[int, TransferError] = {}
        self._aborted: Optional[BoxError] = None
        self._local: Optional[BaseException] = None     # first LOCAL_ERR
        self.pages = num_requests
        if num_requests == 0:
            self._event.set()

    def resolve(self, req: WorkRequest, wc: WorkCompletion) -> None:
        with self._lock:
            if self._aborted is not None:
                return
            if wc.error is not None:
                if self._local is None:
                    self._local = wc.error
            elif wc.status != WCStatus.SUCCESS:
                self._errors[req.remote_addr] = TransferError(wc)
            self._remaining -= 1
            done = self._remaining <= 0
        if done:
            self._event.set()

    def abort(self, exc: BoxError) -> None:
        """Fail the whole batch without completions (engine closed
        mid-flight). Waiters are released immediately; ``wait``/``errors``
        raise ``exc``. Idempotent; a no-op once the batch resolved."""
        with self._lock:
            if self._event.is_set():
                return
            self._aborted = exc
            self._remaining = 0
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def remaining(self) -> int:
        with self._lock:
            return self._remaining

    def errors(self, timeout: Optional[float] = None) -> Dict[int, TransferError]:
        """Wait for the whole batch, then return the per-page error map
        keyed by remote page index (empty ⇒ every page succeeded).
        Raises TimeoutError while in flight, ClosedError if the engine
        closed mid-flight, and the exception of a LOCAL_ERR move (a failed
        device copy) as itself — otherwise the failover paths inspect
        outcomes per page instead of unwinding on the first error."""
        if not self._event.wait(timeout=timeout):
            raise TimeoutError("batched RDMA transfer did not complete in time")
        with self._lock:
            if self._aborted is not None:
                raise self._aborted
            if self._local is not None:
                raise self._local
            return dict(self._errors)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Wait for the whole batch; raises ``BatchTransferError`` if any
        page failed, ``TimeoutError`` if the batch is still in flight."""
        errs = self.errors(timeout=timeout)
        if errs:
            raise BatchTransferError(errs)


@dataclass
class BoxConfig:
    channels_per_peer: int = 4
    batch_policy: BatchPolicy = BatchPolicy.HYBRID
    reg_mode: RegMode = RegMode.AUTO
    kernel_space: bool = True
    window_bytes: Optional[int] = 8 << 20       # ≈ the paper's ~7MB window
    max_drain: int = 64
    poll: PollConfig = field(default_factory=PollConfig)
    nic_cost: NICCostModel = field(default_factory=NICCostModel)
    nic_scale: float = 1e-6
    app_handler: Optional[Callable[[WorkCompletion], None]] = None
    # admission policy plugged into the window (e.g. CongestionAwareHook);
    # None keeps the paper prototype's static window
    admission_hook: Optional[AdmissionHook] = None
    # bounded in-engine retry for transient RNR completions: a request is
    # resubmitted through the merge queue (with exponential backoff) up to
    # this many times before the error surfaces to the caller / paging
    rnr_retry_limit: int = 3
    rnr_backoff_us: float = 200.0               # virtual us, doubles per try
    # decorrelated jitter on the RNR replay backoff: clients that fault
    # together otherwise replay in deterministic lockstep, re-colliding
    # their NAK bursts at the donor. None (default) keeps the historical
    # deterministic doubling bit-exact; an int seeds the jitter RNG so
    # runs stay reproducible.
    rnr_jitter_seed: Optional[int] = None


class RDMABox:
    def __init__(self, node_id: int, directory: Optional[RegionDirectory] = None,
                 peers: Optional[List[int]] = None,
                 config: Optional[BoxConfig] = None,
                 fabric=None,
                 device: Union[str, torch.device] = "cuda") -> None:
        """The node-level engine facade, as one endpoint of a fabric.

        Pass ``fabric`` (a ``repro_torch.fabric.Fabric``) to join a multi-node
        cluster: the box's NIC is created by (and owned by) the fabric,
        wired to per-destination links and the fabric's fault state. The
        legacy ``(directory, peers)`` form still works — it builds a
        private single-client fabric with default (near-ideal) links, on
        ``device`` (without a GPU it raises unless that is ``"cpu"``); with
        ``fabric`` the box takes the fabric's device.
        """
        self.node_id = node_id
        self.cfg = config or BoxConfig()
        self._owns_fabric = fabric is None
        if fabric is None:
            warn_once(
                "RDMABox-legacy",
                "RDMABox(node, directory, peers) with a private fabric is "
                "deprecated; build the cluster with repro_torch.box.open(spec) "
                "and use session.engine() (or pass fabric= explicitly)")
            from ..fabric import Fabric   # deferred: fabric imports core
            if directory is None:
                raise ValueError("RDMABox needs a directory or a fabric")
            fabric = Fabric(directory=directory, cost=self.cfg.nic_cost,
                            scale=self.cfg.nic_scale,
                            kernel_space=self.cfg.kernel_space,
                            device=device)
        self.fabric = fabric
        # client-side buffers this engine allocates live on the fabric's
        # device; donor memory stays on the host
        self.device = fabric.device
        self.directory = fabric.directory
        self.peers = list(peers) if peers is not None \
            else fabric.peers_of(node_id)
        self.nic = fabric.add_node(node_id)
        scq = (self.cfg.poll.scq_count
               if self.cfg.poll.mode == PollMode.SCQ else 0)
        self.channels = ChannelSet(
            self.nic, self.peers,
            channels_per_peer=self.cfg.channels_per_peer,
            shared_cqs=scq,
        )
        self.admission = AdmissionController(self.cfg.window_bytes,
                                             hook=self.cfg.admission_hook)
        # striped futures table: shard locks keyed by wr_id
        self._futures: List[Dict[int, object]] = \
            [{} for _ in range(_FUTURE_SHARDS)]
        self._futures_locks = [threading.Lock()
                               for _ in range(_FUTURE_SHARDS)]
        # flush(): event-driven drain tracking of in-flight requests
        self._pending = 0
        self._pending_cv = threading.Condition()
        self._retries: Dict[int, int] = {}      # wr_id -> RNR attempts so far
        self._retries_lock = threading.Lock()
        # decorrelated-jitter state: wr_id -> previous backoff delay (us);
        # only populated when cfg.rnr_jitter_seed is set
        self._retry_delay_us: Dict[int, float] = {}
        self._rnr_rng = (random.Random(self.cfg.rnr_jitter_seed)
                         if self.cfg.rnr_jitter_seed is not None else None)
        self.rnr_retries = AtomicCounter()
        self.callback_errors = AtomicCounter()
        # post→completion virtual latency of every successful transfer —
        # the client-side tail the paper's Fig. 1 is about; lands at
        # ``client.<i>.box.latency.*`` in the session stats tree
        self.latency = LatencyHistogram()
        self._cb_log_lock = threading.Lock()
        self._logged_cb_sites: set = set()
        self._closed = False
        # one merge queue per verb, as in the paper
        self._queues = {
            Verb.READ: MergeQueue(self._make_poster(), self.admission,
                                  max_drain=self.cfg.max_drain),
            Verb.WRITE: MergeQueue(self._make_poster(), self.admission,
                                   max_drain=self.cfg.max_drain),
        }
        self.poller = Poller(self.cfg.poll, self.channels.all_cqs(),
                             self._on_completions)
        self.poller.start()
        self._crossover = self.cfg.nic_cost.crossover_pages()

    # ---- public API --------------------------------------------------------
    def write(self, dest_node: int, page: int, data: torch.Tensor,
              num_pages: Optional[int] = None,
              callback: Optional[Callable[[WorkCompletion], None]] = None,
              ) -> TransferFuture:
        """Async write of ``data`` (a tensor on any device; its bytes, not
        its values, are moved) to ``page`` on ``dest_node``."""
        data = byte_view(data)
        n = num_pages or max(1, data.nbytes // PAGE_SIZE)
        return self._submit(Verb.WRITE, dest_node, page, n, data, callback)

    def read(self, dest_node: int, page: int, num_pages: int,
             out: Optional[torch.Tensor] = None,
             callback: Optional[Callable[[WorkCompletion], None]] = None,
             ) -> TransferFuture:
        """Async read into ``out`` (any device), or into a fresh byte
        buffer on the engine's device, reachable from the completion's
        request payload, when ``out`` is None."""
        if out is not None:
            out = byte_view(out, writable=True)
        return self._submit(Verb.READ, dest_node, page, num_pages, out,
                            callback)

    def write_pages(self, dest_node: int,
                    pages: Sequence[Tuple[int, torch.Tensor]],
                    callbacks: Optional[Sequence[Optional[Callable]]] = None,
                    ) -> BatchFuture:
        """Batched write: a vector of (remote page, buffer-view) pairs.

        The vector is sorted by remote page and enters the merge queue as
        one pre-formed run under a single lock acquisition; adjacent pages
        merge into single WQEs on the way to the NIC. The buffers are
        referenced, not copied, until the NIC moves them (zero-copy
        scatter-gather). ``callbacks``, when given, is parallel to
        ``pages`` and fires per page completion (before any waiter on the
        returned future is released)."""
        return self._submit_batch(Verb.WRITE, dest_node, pages, callbacks)

    def read_pages(self, dest_node: int,
                   pages: Sequence[Tuple[int, torch.Tensor]],
                   callbacks: Optional[Sequence[Optional[Callable]]] = None,
                   ) -> BatchFuture:
        """Batched read: each (remote page, out-buffer) pair is filled in
        place — the donor-side copy lands directly in the caller's buffer.
        Same single-lock single-future hot path as ``write_pages``."""
        return self._submit_batch(Verb.READ, dest_node, pages, callbacks)

    def flush(self, timeout: float = 30.0) -> None:
        """Wait until every submitted transfer has completed.

        Event-driven: sleeps on a condition variable that the batched
        completion handler signals when the futures table drains — no
        poll-sleep on the waiter and no wakeups while traffic is still in
        flight."""
        with self._pending_cv:
            if not self._pending_cv.wait_for(lambda: self._pending <= 0,
                                             timeout=timeout):
                raise TimeoutError("flush timed out with transfers in flight")

    def close(self) -> None:
        """Tear the engine down (idempotent). Transfers still in flight
        fail their futures with ``ClosedError`` immediately — waiters are
        released now instead of hitting their flush/wait timeouts."""
        if self._closed:
            return
        self._closed = True
        self.poller.stop()
        self.channels.close()
        self.nic.close()
        if self._owns_fabric:
            self.fabric.close()
        err = ClosedError(
            f"RDMABox(node {self.node_id}) closed with transfers in flight")
        aborted: List[object] = []
        for s in range(_FUTURE_SHARDS):
            with self._futures_locks[s]:
                if self._futures[s]:
                    aborted.extend(self._futures[s].values())
                    self._futures[s].clear()
        for fut in aborted:             # BatchFutures repeat per page;
            fut.abort(err)              # abort is idempotent
        with self._pending_cv:
            self._pending = 0
            self._pending_cv.notify_all()

    def snapshot(self) -> Dict[str, object]:
        """Engine-local stats node for the composed session tree (the
        NIC/fabric views live under their own ``nic.*``/``fabric.*``
        namespaces there)."""
        qr, qw = self._queues[Verb.READ], self._queues[Verb.WRITE]
        drains = qr.drains.value + qw.drains.value
        drained = qr.drained_requests.value + qw.drained_requests.value
        return {
            "poll": self.poller.stats.snapshot(),
            "admission": self.admission.snapshot(),
            "latency": self.latency.snapshot(),
            "rnr_retries": self.rnr_retries.value,
            "callback_errors": self.callback_errors.value,
            "pending_requests": self._pending,
            "merge": {
                "submitted": qr.submitted.value + qw.submitted.value,
                "drains": drains,
                "drained_requests": drained,
                # avg requests per posting event — the WQE-reduction
                # opportunity the merge queue actually realized
                "merge_ratio": drained / max(1, drains),
                "solo_posts": qr.solo_posts.value + qw.solo_posts.value,
            },
        }

    def stats(self) -> Dict[str, object]:
        """Legacy flat stats dict (pre-``repro_torch.box`` shape); new code
        should read ``Session.stats()``'s composed tree instead."""
        snap = self.snapshot()
        admission = snap.pop("admission")
        out = {
            "nic": self.nic.stats.snapshot(),
            "faults": self.fabric.faults.snapshot(),
            "admission_blocked": admission["blocked"],
            "admission_limit": admission["limit"],
            "in_flight_bytes": admission["in_flight_bytes"],
            **snap,
        }
        if "hook" in admission:
            out["admission_hook"] = admission["hook"]
        return out

    # ---- engine internals ----------------------------------------------------
    def _submit(self, verb: Verb, dest: int, page: int, num_pages: int,
                payload, callback=None) -> TransferFuture:
        if self._closed:
            raise ClosedError(f"RDMABox(node {self.node_id}) is closed")
        wr = WorkRequest(verb=verb, dest_node=dest, remote_addr=page,
                         num_pages=num_pages, payload=payload,
                         enqueue_time=time.perf_counter(),
                         callback=callback, ready=ready_event([payload]))
        fut = TransferFuture()
        with self._futures_locks[wr.wr_id & _SHARD_MASK]:
            self._futures[wr.wr_id & _SHARD_MASK][wr.wr_id] = fut
        with self._pending_cv:
            self._pending += 1
        # close() may have drained the futures shards between the guard at
        # the top and our insert — re-check so no future outlives close
        # unaborted (close sets _closed BEFORE draining, so seeing it False
        # here means the drain will observe our insert)
        if self._closed:
            self._unregister([wr])
            raise ClosedError(f"RDMABox(node {self.node_id}) is closed")
        self._queues[verb].submit(wr)
        return fut

    def _submit_batch(self, verb: Verb, dest: int,
                      pages: Sequence[Tuple[int, torch.Tensor]],
                      callbacks: Optional[Sequence[Optional[Callable]]],
                      ) -> BatchFuture:
        if self._closed:
            raise ClosedError(f"RDMABox(node {self.node_id}) is closed")
        if callbacks is None:
            callbacks = (None,) * len(pages)
        elif len(callbacks) != len(pages):
            # a short callbacks vector would silently zip-truncate the
            # page vector and leave the BatchFuture unresolvable
            raise ValueError(
                f"callbacks length {len(callbacks)} != pages length "
                f"{len(pages)}")
        fut = BatchFuture(len(pages))
        if not pages:
            return fut
        # sorted by remote page ⇒ the vector is a pre-formed run (or a few),
        # so max_drain windows drain it in mergeable order
        items = sorted(zip(pages, callbacks), key=lambda it: it[0][0])
        now = time.perf_counter()
        bufs = [None if buf is None
                else byte_view(buf, writable=verb == Verb.READ)
                for (_, buf), _ in items]
        # one event for the vector: every copy is ordered after the work
        # the submitting thread queued on its buffers
        ready = ready_event(bufs)
        wrs = []
        for ((page, _), cb), buf in zip(items, bufs):
            n = max(1, buf.nbytes // PAGE_SIZE) if buf is not None else 1
            wrs.append(WorkRequest(verb=verb, dest_node=dest,
                                   remote_addr=page, num_pages=n,
                                   payload=buf, enqueue_time=now,
                                   callback=cb, ready=ready))
        # register the whole vector: one lock acquisition per touched shard,
        # one pending-count update
        by_shard: Dict[int, List[WorkRequest]] = {}
        for wr in wrs:
            by_shard.setdefault(wr.wr_id & _SHARD_MASK, []).append(wr)
        for s, group in by_shard.items():
            table = self._futures[s]
            with self._futures_locks[s]:
                for wr in group:
                    table[wr.wr_id] = fut
        with self._pending_cv:
            self._pending += len(wrs)
        # same close() race as _submit: re-check after registration
        if self._closed:
            self._unregister(wrs)
            raise ClosedError(f"RDMABox(node {self.node_id}) is closed")
        self._queues[verb].submit_many(wrs)
        return fut

    def _unregister(self, wrs: Sequence[WorkRequest]) -> None:
        """Back out futures registered by a submit that lost the race with
        close(); a pop may find the entry already drained (and aborted)."""
        for wr in wrs:
            with self._futures_locks[wr.wr_id & _SHARD_MASK]:
                self._futures[wr.wr_id & _SHARD_MASK].pop(wr.wr_id, None)
        with self._pending_cv:
            self._pending -= len(wrs)
            if self._pending <= 0:
                self._pending_cv.notify_all()

    def _make_poster(self) -> Callable[[List[WorkRequest]], None]:
        cfg = self.cfg

        def poster(batch: List[WorkRequest]) -> None:
            groups = plan(cfg.batch_policy, batch, cfg.reg_mode,
                          kernel_space=cfg.kernel_space,
                          crossover_pages=self._crossover)
            for descs, doorbell in groups:
                # posting groups from plan() share one destination per desc;
                # split by destination channel, preserving chain structure.
                by_dest: Dict[int, List] = {}
                for d in descs:
                    by_dest.setdefault(d.dest_node, []).append(d)
                for dest, dd in by_dest.items():
                    nbytes = sum(d.nbytes for d in dd)
                    self.admission.acquire(nbytes)
                    self.channels.pick(dest).post(dd, doorbell=doorbell)

        return poster

    def _on_completions(self, wcs: List[WorkCompletion]) -> None:
        """Batched completion handler: the poller hands the whole polled
        list, so the admission release is ONE window update and future
        pops are one lock acquisition per touched shard."""
        total = 0
        hook = self.admission.hook
        app = self.cfg.app_handler
        for wc in wcs:
            total += wc.nbytes
            hook.observe(wc)
            if app is not None:
                app(wc)
        self.admission.release(total)
        self.latency.record_many(
            wc.latency_us for wc in wcs if wc.status is WCStatus.SUCCESS)
        # requests being retried stay in flight; everything else resolves now
        work: List[Tuple[WorkCompletion, WorkRequest]] = []
        for wc in wcs:
            retried = self._maybe_retry(wc)
            if retried:
                work.extend((wc, r) for r in wc.requests
                            if r.wr_id not in retried)
            else:
                work.extend((wc, r) for r in wc.requests)
        if not work:
            return
        by_shard: Dict[int, List[int]] = {}
        for i, (_, r) in enumerate(work):
            by_shard.setdefault(r.wr_id & _SHARD_MASK, []).append(i)
        futs: List = [None] * len(work)
        for s, idxs in by_shard.items():
            table = self._futures[s]
            with self._futures_locks[s]:
                for i in idxs:
                    futs[i] = table.pop(work[i][1].wr_id, None)
        if self._retries:
            with self._retries_lock:
                for _, r in work:
                    self._retries.pop(r.wr_id, None)
                    self._retry_delay_us.pop(r.wr_id, None)
        popped = 0
        for (wc, r), fut in zip(work, futs):
            # callback BEFORE the future resolves: a thread released by
            # fut.wait() must observe the callback's bookkeeping (e.g. the
            # paging write-buffer release) as already done. A raising
            # callback must not take down the poller thread with it.
            if r.callback is not None:
                try:
                    r.callback(wc)
                except Exception:
                    self._note_callback_error(r.callback)
            if fut is not None:
                fut.resolve(r, wc)
                popped += 1
        if popped:
            with self._pending_cv:
                self._pending -= popped
                if self._pending <= 0:
                    self._pending_cv.notify_all()

    def _note_callback_error(self, cb) -> None:
        """Swallowed-exception accounting: every callback failure counts in
        ``callback_errors``; the full traceback is logged once per distinct
        callback site so a hot loop cannot flood the log."""
        self.callback_errors.add()
        site = getattr(cb, "__qualname__", None) or repr(cb)
        with self._cb_log_lock:
            first = site not in self._logged_cb_sites
            if first:
                self._logged_cb_sites.add(site)
        if first:
            logger.exception(
                "completion callback %s raised (suppressed; counted in "
                "callback_errors, logged once per site)", site)

    def _maybe_retry(self, wc: WorkCompletion) -> set:
        """Bounded in-engine retry for transient (RNR) completions: each
        request rides the merge queue again after exponential backoff.
        Returns the wr_ids being retried (their futures stay pending)."""
        if wc.status is not WCStatus.RNR_RETRY_ERR \
                or self.cfg.rnr_retry_limit <= 0 or self._closed:
            return set()
        retried: List[tuple] = []
        for r in wc.requests:
            with self._futures_locks[r.wr_id & _SHARD_MASK]:
                present = r.wr_id in self._futures[r.wr_id & _SHARD_MASK]
            if not present:
                continue
            with self._retries_lock:
                attempt = self._retries.get(r.wr_id, 0)
                if attempt < self.cfg.rnr_retry_limit:
                    self._retries[r.wr_id] = attempt + 1
                    retried.append((r, attempt + 1))
        # requests that faulted in one work request and wait as long are
        # resubmitted together (one ``submit_many``), so they merge again as
        # they faulted: one timer each let the merger drain between their
        # resubmits, split the replay into several work requests, and count
        # one fault's replay more than once
        groups: Dict[Tuple[float, Verb], List[WorkRequest]] = {}
        for r, attempt in retried:
            self.rnr_retries.add()
            delay = self._rnr_delay_us(r.wr_id, attempt) * self.cfg.nic_scale
            groups.setdefault((delay, r.verb), []).append(r)
        for (delay, _), wrs in groups.items():
            timer = threading.Timer(delay, self._resubmit, args=(wrs,))
            timer.daemon = True
            timer.start()
        return {r.wr_id for r, _ in retried}

    def _rnr_delay_us(self, wr_id: int, attempt: int) -> float:
        """Backoff (virtual us) before replaying an RNR-NAK'd request.

        Default: deterministic doubling of ``rnr_backoff_us`` — the
        historical behavior, kept bit-exact. With ``rnr_jitter_seed``
        set, decorrelated jitter: ``min(cap, uniform(base, 3 * prev))``,
        capped at what deterministic doubling would reach on the final
        allowed attempt — co-faulting clients spread their replays
        instead of re-colliding at the donor in lockstep.
        """
        base = self.cfg.rnr_backoff_us
        if self._rnr_rng is None:
            return base * (2 ** (attempt - 1))
        cap = base * (2 ** max(0, self.cfg.rnr_retry_limit - 1))
        with self._retries_lock:
            prev = self._retry_delay_us.get(wr_id, base)
            delay = min(cap, self._rnr_rng.uniform(base, prev * 3.0))
            self._retry_delay_us[wr_id] = delay
        return delay

    def _resubmit(self, wrs: List[WorkRequest]) -> None:
        if self._closed:
            return
        now = time.perf_counter()
        for wr in wrs:
            wr.enqueue_time = now
        self._queues[wrs[0].verb].submit_many(wrs)
