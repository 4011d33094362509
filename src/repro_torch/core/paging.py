"""Remote paging system (§6, §7.1) — the paper's kernel-space showcase.

Page-granular swap to remote memory with replication over ``r`` donor
nodes and disk fallback ("disk access occurs only when all replication is
failed"). Page placement is striped so that *consecutive local pages map to
contiguous remote pages on the same donor* — that is precisely the locality
load-aware batching exploits: a burst of sequential swap-outs merges into a
handful of large WQEs.

Replica layout: donor count n, stripe S, replication r. Page p belongs to
group g = p // S; replica k lives on donor (g + k) % n at offset
``k * (donor_pages // r) + (g // n) * S + (p % S)`` — per-replica regions
are disjoint, so replicas never collide.

Failover (exercised by ``repro_torch.fabric`` fault injection):

* **reads** — replicas are tried in order; an error WorkCompletion
  (inspected via ``TransferFuture.exception()``, no try/except needed)
  records a *strike* against the donor and falls over to the next
  replica. ``first_responder=True`` instead launches reads to all live
  replicas at once and returns the first success — the straggler-
  tolerant path. Disk is consulted only when every replica has failed.
* **writes** — ``wait=True`` collects per-replica outcomes; donors that
  error are struck, and if *zero* replicas acknowledged, the page is
  persisted to disk so it is never silently lost.
* **eviction** — ``evict_after`` consecutive strikes marks a donor
  failed (no further traffic); a later ``recover_node`` clears it.
* **write buffer** — a page with swap-out writes still in flight is
  served from the in-memory write buffer (Linux swap-cache semantics).
  RDMA orders operations only within one QP, and the engine stripes a
  page's write and a later read across channels/QPs — without the
  buffer, an async swap-out racing its own swap-in could read stale
  donor bytes. Entries release when every replica write has completed.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from .._deprecation import warn_once
from .buffers import byte_view
from .descriptors import PAGE_SIZE, AtomicCounter
from .rdmabox import BatchFuture, RDMABox, TransferFuture


def _one_page(data: torch.Tensor, what: str) -> torch.Tensor:
    """``data``'s bytes as a flat view of exactly one page — a view of
    its bytes, never a cast of its values."""
    buf = byte_view(data)
    if buf.dim() != 1:                  # a reshape can let the GIL go
        buf = buf.reshape(-1)
    if buf.numel() != PAGE_SIZE:
        raise ValueError(f"{what} takes exactly one page ({PAGE_SIZE} "
                         f"bytes), got {buf.numel()}")
    return buf


class StripedPlacement:
    """The paper's striped replica layout (the default placement policy).

    Donor count n, stripe S, replication r: page p belongs to group
    g = p // S; replica k lives on donor (g + k) % n at offset
    ``k * (region_pages // r) + (g // n) * S + (p % S)`` — per-replica
    regions are disjoint, so replicas never collide, and consecutive
    local pages land on contiguous remote pages of the same donor (the
    locality load-aware batching exploits).

    Alternative policies register under the ``placement`` kind of the
    ``repro_torch.box`` policy registry and are selected by name in a
    ``ClusterSpec``; they must honor the same two invariants (replicas of
    one page on distinct donors, no two pages sharing a donor page).
    """

    def capacity_pages(self, ps: "RemotePagingSystem") -> int:
        return (ps.replica_region // ps.stripe) * ps.n * ps.stripe

    def replicas(self, ps: "RemotePagingSystem",
                 page_id: int) -> List[Tuple[int, int]]:
        g, off = divmod(page_id, ps.stripe)
        out = []
        for k in range(ps.r):
            donor = ps.donors[(g + k) % ps.n]
            remote = (ps.region_base + k * ps.replica_region
                      + (g // ps.n) * ps.stripe + off)
            out.append((donor, remote))
        return out


class DiskTier:
    """Slow backing store of last resort (dict + simulated latency). Its
    copies are host memory, whatever device the page came from."""

    def __init__(self, latency_us: float = 100.0) -> None:
        self.latency_us = latency_us
        self._store: Dict[int, torch.Tensor] = {}
        self._lock = threading.Lock()
        self.reads = 0
        self.writes = 0

    def write(self, page_id: int, data: torch.Tensor) -> None:
        copy = byte_view(data).reshape(-1).to("cpu", copy=True)
        with self._lock:
            self._store[page_id] = copy
            self.writes += 1

    def read(self, page_id: int) -> Optional[torch.Tensor]:
        time.sleep(self.latency_us * 1e-6)
        with self._lock:
            self.reads += 1
            data = self._store.get(page_id)
            return None if data is None else data.clone()


class RemotePagingSystem:
    def __init__(
        self,
        box: RDMABox,
        donor_pages: int,
        replication: int = 2,
        stripe_pages: int = 16,
        disk: Optional[DiskTier] = None,
        write_through_disk: bool = False,
        first_responder: bool = False,
        evict_after: int = 3,
        region_base: int = 0,
        region_pages: Optional[int] = None,
        placement: Optional[StripedPlacement] = None,
    ) -> None:
        """``region_base``/``region_pages`` carve this paging system's slice
        out of each donor's region. Multiple clients sharing donors MUST use
        disjoint slices — placement is a pure function of page_id, so two
        clients with the same slice would overwrite each other's pages.

        ``placement`` swaps the replica-layout policy (default: the
        paper's striped layout); named policies come from the
        ``repro_torch.box`` placement registry."""
        if not getattr(self, "_box_internal", False):
            warn_once(
                "RemotePagingSystem",
                "constructing RemotePagingSystem directly is deprecated; "
                "use repro_torch.box.open(spec).pager()")
        self.box = box
        self.donors = list(box.peers)
        self.n = len(self.donors)
        self.r = min(replication, self.n)
        self.stripe = stripe_pages
        self.donor_pages = donor_pages
        self.region_base = region_base
        self.region_pages = region_pages if region_pages is not None \
            else donor_pages - region_base
        if region_base + self.region_pages > donor_pages:
            raise ValueError(
                f"region slice [{region_base}, "
                f"{region_base + self.region_pages}) exceeds donor region "
                f"of {donor_pages} pages")
        self.replica_region = self.region_pages // max(1, self.r)
        self.disk = disk or DiskTier()
        self.write_through_disk = write_through_disk
        self.first_responder = first_responder
        self.evict_after = evict_after
        self._failed: set[int] = set()
        self._strikes: Dict[int, int] = {}
        # (donor, page_id) pairs whose last acked write failed on that donor:
        # the replica may hold stale data and must not serve reads until a
        # later write to it succeeds. Only the acked (wait=True) write path
        # can observe failures, so only it maintains this.
        self._stale: set[Tuple[int, int]] = set()
        # in-flight swap-outs: page_id -> [newest bytes, writes outstanding
        # across ALL overlapping swap-outs, racing?]. ``racing`` marks a
        # page whose writes were posted concurrently (different QPs can
        # reorder them at the donor): once the count drains, the newest
        # bytes are re-issued so the donor provably converges to them.
        self._wb: Dict[int, list] = {}
        self._lock = threading.Lock()
        self.placement = placement or StripedPlacement()
        self.capacity_pages = self.placement.capacity_pages(self)
        # failover telemetry (swap APIs are called from many threads)
        self.read_failovers = AtomicCounter()   # reads not served by primary
        self.write_failures = AtomicCounter()   # replica writes that errored
        self.disk_fallback_reads = AtomicCounter()
        self.write_buffer_hits = AtomicCounter()  # reads served in-flight
        self.evictions = 0                      # guarded by self._lock

    # ---- placement ---------------------------------------------------------
    def replicas(self, page_id: int) -> List[Tuple[int, int]]:
        """[(donor_node, remote_page)] for each replica of ``page_id``."""
        if page_id >= self.capacity_pages:
            raise ValueError(f"page {page_id} beyond capacity {self.capacity_pages}")
        return self.placement.replicas(self, page_id)

    # ---- donor health ------------------------------------------------------
    def fail_node(self, node: int) -> None:
        with self._lock:
            self._failed.add(node)

    def recover_node(self, node: int) -> None:
        with self._lock:
            self._failed.discard(node)
            self._strikes.pop(node, None)

    def _live(self, node: int) -> bool:
        with self._lock:
            return node not in self._failed

    def live_replicas(self, page_id: int) -> List[Tuple[int, int]]:
        return [(d, a) for d, a in self.replicas(page_id) if self._live(d)]

    def _strike(self, node: int) -> None:
        """One observed failure against a donor; evict on a streak."""
        with self._lock:
            s = self._strikes.get(node, 0) + 1
            self._strikes[node] = s
            if s >= self.evict_after and node not in self._failed:
                self._failed.add(node)
                self.evictions += 1

    def _clear_strikes(self, node: int) -> None:
        with self._lock:
            self._strikes.pop(node, None)

    # ---- in-flight write buffer -------------------------------------------
    def _wb_register(self, page_id: int, buf, n_writes: int):
        """Pin the page's bytes while its replica writes are in flight;
        returns the per-write completion callback that unpins it.

        Overlapping swap-outs of the same page accumulate one shared
        outstanding count (the entry lives until EVERY write has
        completed) and mark the page *racing*: the writes rode different
        QPs and may land at the donor in either order, so when the count
        drains the newest bytes are written once more — posted after all
        others completed, nothing can reorder past it."""
        if n_writes <= 0:
            return None
        with self._lock:
            entry = self._wb.get(page_id)
            if entry is None:
                self._wb[page_id] = [buf.clone(), n_writes, False]
            else:
                entry[0] = buf.clone()      # newest bytes win
                if entry[1] > 0:            # concurrent writes in flight
                    entry[2] = True         # donor order now ambiguous
                entry[1] += n_writes        # count 0 = the settling rewrite

        def done(_wc, page_id=page_id) -> None:
            rewrite = None
            with self._lock:
                entry = self._wb.get(page_id)
                if entry is None:
                    return
                entry[1] -= 1
                if entry[1] > 0:
                    return
                if entry[2]:
                    entry[2] = False        # re-issue settles the race
                    rewrite = entry[0]
                else:
                    del self._wb[page_id]
            if rewrite is not None:
                # not inline: this callback runs on a poller thread, and
                # swap_out can block on the admission window — which only
                # drains through poller threads
                t = threading.Timer(0.0, self.swap_out, args=(page_id, rewrite))
                t.daemon = True
                t.start()

        return done

    def _wb_lookup(self, page_id: int):
        with self._lock:
            entry = self._wb.get(page_id)
            return None if entry is None else entry[0].clone()

    def read_inflight(self, page_id: int) -> Optional[torch.Tensor]:
        """The page's bytes if its swap-out is still in flight, else None.
        Read paths that bypass ``swap_in`` (prefetch bursts) MUST consult
        this first, or they can read stale donor bytes."""
        pending = self._wb_lookup(page_id)
        if pending is not None:
            self.write_buffer_hits.add()
        return pending

    # ---- swap API ---------------------------------------------------------
    def swap_out(self, page_id: int, data: torch.Tensor,
                 wait: bool = False, timeout: float = 30.0) -> List[TransferFuture]:
        """Write one page to all live replicas (async by default).

        ``data`` is a tensor of exactly ``PAGE_SIZE`` bytes, of any dtype
        and on any device: its bytes are viewed, never its values cast.
        With ``wait=True`` the outcome of every replica write is
        inspected: failed donors are struck, and when no replica
        acknowledged (or none was live to begin with), the page goes to
        disk so durability is never silently lost. A failed copy on this
        host (not a remote fault) raises as itself, striking nothing.
        """
        buf = _one_page(data, "swap_out")
        targets = self.live_replicas(page_id)
        done = self._wb_register(page_id, buf, len(targets))
        futs = [self.box.write(donor, remote, buf, callback=done)
                for donor, remote in targets]
        on_disk = self.write_through_disk or not futs
        if on_disk:
            self.disk.write(page_id, buf)
        if wait:
            self._resolve_write_acks(page_id, buf, targets, futs, on_disk,
                                     timeout)
        return futs

    def swap_out_batch(self, items: List[Tuple[int, torch.Tensor]],
                       timeout: float = 30.0,
                       wait: bool = True) -> List[BatchFuture]:
        """Bulk swap-out on the batched zero-copy hot path.

        Every page's replica writes are grouped per donor and posted as
        ONE ``write_pages`` vector per donor — a single merge-queue lock
        acquisition and one ``BatchFuture`` per donor instead of
        pages x replicas futures — so the merge queue and admission window
        see the whole burst at once. With ``wait=True`` each page's
        per-replica outcomes are then resolved with the same strike /
        stale / disk-persist bookkeeping as ``swap_out(wait=True)``;
        ``wait=False`` is the async fire-and-forget mirror (write-buffer
        protection still applies) and returns the per-donor futures for
        the caller to drain."""
        by_donor: Dict[int, Tuple[list, list]] = {}
        page_info = []
        for page_id, data in items:
            buf = _one_page(data, "swap_out_batch")
            targets = self.live_replicas(page_id)
            done = self._wb_register(page_id, buf, len(targets))
            for donor, remote in targets:
                pairs, cbs = by_donor.setdefault(donor, ([], []))
                pairs.append((remote, buf))
                cbs.append(done)
            on_disk = self.write_through_disk or not targets
            if on_disk:
                self.disk.write(page_id, buf)
            page_info.append((page_id, buf, targets, on_disk))
        futs = {donor: self.box.write_pages(donor, pairs, callbacks=cbs)
                for donor, (pairs, cbs) in by_donor.items()}
        if not wait:
            return list(futs.values())
        # None = the donor's whole vector timed out (outcome unknown ⇒
        # treated as failed, same as a timed-out per-page ack)
        errmaps: Dict[int, Optional[Dict]] = {}
        for donor, fut in futs.items():
            try:
                errmaps[donor] = fut.errors(timeout=timeout)
            except TimeoutError:
                errmaps[donor] = None
        for page_id, buf, targets, on_disk in page_info:
            acks = 0
            for donor, remote in targets:
                errs = errmaps[donor]
                err = TimeoutError() if errs is None else errs.get(remote)
                if self._note_replica_outcome(donor, page_id, err):
                    acks += 1
            if acks == 0 and not on_disk:
                self.disk.write(page_id, buf)   # all replicas failed
        return list(futs.values())

    def _note_replica_outcome(self, donor: int, page_id: int,
                              err: Optional[Exception]) -> bool:
        """Strike / stale bookkeeping for ONE replica write outcome (the
        single source of truth for both the per-page and batched ack
        paths); returns True when the replica acknowledged."""
        if err is None:
            self._clear_strikes(donor)
            with self._lock:
                self._stale.discard((donor, page_id))
            return True
        self._strike(donor)
        self.write_failures.add()
        with self._lock:            # replica kept its old bytes: stale
            self._stale.add((donor, page_id))
        return False

    def _resolve_write_acks(self, page_id: int, buf: torch.Tensor,
                            targets: List[Tuple[int, int]], futs,
                            on_disk: bool, timeout: float) -> None:
        acks = 0
        for (donor, _), fut in zip(targets, futs):
            try:
                err = fut.exception(timeout=timeout)
            except TimeoutError:
                err = TimeoutError()
            if self._note_replica_outcome(donor, page_id, err):
                acks += 1
        if acks == 0 and not on_disk:
            self.disk.write(page_id, buf)   # all replicas failed

    def swap_in(self, page_id: int, timeout: float = 10.0) -> torch.Tensor:
        """Read a page back (a fresh byte buffer on the engine's device):
        replica failover first, disk as last resort.

        ``read_failovers`` counts every read *not* served by the page's
        primary replica — whether the primary errored live, held stale
        data from a failed write, or its donor was already evicted.
        """
        pending = self.read_inflight(page_id)
        if pending is not None:         # swap-out still in flight: serve
            return pending              # the freshest bytes locally
        with self._lock:
            stale = set(self._stale)
        reps = [(k, d, a) for k, (d, a) in enumerate(self.replicas(page_id))
                if self._live(d) and (d, page_id) not in stale]
        if self.first_responder and len(reps) > 1:
            data = self._first_responder_read(reps, timeout)
            if data is not None:
                return data
        else:
            for k, donor, remote in reps:
                # fresh buffer per attempt: a timed-out straggler read may
                # complete later and must never scribble on returned data
                out = torch.empty(PAGE_SIZE, dtype=torch.uint8,
                                  device=self.box.device)
                fut = self.box.read(donor, remote, 1, out=out)
                try:
                    err = fut.exception(timeout=timeout)
                except TimeoutError:
                    self._strike(donor)
                    continue
                if err is None:
                    self._clear_strikes(donor)
                    if k > 0:
                        self.read_failovers.add()
                    return out
                self._strike(donor)
        # every replica failed ⇒ the paper's last resort
        data = self.disk.read(page_id)
        self.disk_fallback_reads.add()
        if data is None:
            raise KeyError(f"page {page_id} lost: all replicas failed, not on disk")
        return data.to(self.box.device)

    def _first_responder_read(self, reps: List[Tuple[int, int, int]],
                              timeout: float) -> Optional[torch.Tensor]:
        """Race all live replicas; first successful completion wins.

        Each replica reads into its own buffer, so a late (or corrupt-
        status) straggler can never overwrite the winner's data.
        """
        bufs = [torch.empty(PAGE_SIZE, dtype=torch.uint8,
                            device=self.box.device) for _ in reps]
        futs = [self.box.read(d, a, 1, out=b)
                for (_, d, a), b in zip(reps, bufs)]
        deadline = time.perf_counter() + timeout
        pending = set(range(len(futs)))
        while pending and time.perf_counter() < deadline:
            for i in sorted(pending):
                if not futs[i].done():
                    continue
                pending.discard(i)
                err = futs[i].exception(timeout=0)
                k, donor, _ = reps[i]
                if err is None:
                    self._clear_strikes(donor)
                    if k > 0:
                        self.read_failovers.add()
                    return bufs[i]
                self._strike(donor)
            if pending:
                time.sleep(50e-6)
        for i in pending:               # timed out: strike the stragglers
            self._strike(reps[i][1])
        return None

    def _first_fresh_replica(self, page_id: int,
                             stale: set) -> Optional[Tuple[int, int]]:
        """First replica that is live AND not known-stale from a failed
        acked write — the same eligibility rule ``swap_in`` applies, so a
        prefetch can never 'succeed' with a replica's old bytes."""
        for donor, remote in self.replicas(page_id):
            if self._live(donor) and (donor, page_id) not in stale:
                return donor, remote
        return None

    def prefetch(self, page_id: int, out: torch.Tensor) -> TransferFuture:
        """Async read from the first fresh replica (straggler-tolerant path)."""
        with self._lock:
            stale = set(self._stale)
        target = self._first_fresh_replica(page_id, stale)
        if target is None:
            raise RuntimeError("no live replicas to prefetch from")
        return self.box.read(target[0], target[1], 1, out=out)

    def prefetch_batch(self, items: List[Tuple[int, torch.Tensor]]
                       ) -> "PrefetchBatch":
        """Post async reads for a whole vector of (page_id, out) pairs.

        Write-buffer hits are served immediately from the in-flight
        swap-out bytes; the rest group by each page's first live replica
        donor into ONE ``read_pages`` vector per donor (the swap-in
        mirror of the bulk swap-out path — single submit-lock
        acquisition, donor-side copies land straight in the caller's
        buffers). ``resolve()`` on the returned handle reports per-page
        success; failed pages should take the ``swap_in`` failover read."""
        by_donor: Dict[int, list] = {}
        slots: List = []
        with self._lock:
            stale = set(self._stale)
        for page_id, out in items:
            pending = self.read_inflight(page_id)
            if pending is not None:     # swap-out still in flight: serve
                dst = byte_view(out, writable=True)     # the freshest bytes
                dst.copy_(pending.reshape(dst.shape))
                slots.append(True)
                continue
            target = self._first_fresh_replica(page_id, stale)
            if target is None:
                slots.append(None)      # no fresh replica: caller fails over
                continue
            by_donor.setdefault(target[0], []).append((target[1], out))
            slots.append(target)
        futs = {donor: self.box.read_pages(donor, pairs)
                for donor, pairs in by_donor.items()}
        return PrefetchBatch(self, slots, futs)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            failed = sorted(self._failed)
        return {
            "read_failovers": self.read_failovers.value,
            "write_failures": self.write_failures.value,
            "write_buffer_hits": self.write_buffer_hits.value,
            "disk_fallback_reads": self.disk_fallback_reads.value,
            "disk_reads": self.disk.reads,
            "disk_writes": self.disk.writes,
            "evictions": self.evictions,
            "failed_donors": failed,
        }

    # legacy name; the session stats tree composes snapshot()
    stats = snapshot


class PrefetchBatch:
    """Handle for one posted ``prefetch_batch`` vector.

    Tracks, per requested page: already served from the write buffer
    (``True``), posted to a donor (``(donor, remote)``), or unservable
    because no replica was live (``None``).
    """

    def __init__(self, paging: RemotePagingSystem, slots: List,
                 futs: Dict[int, BatchFuture]) -> None:
        self._paging = paging
        self._slots = slots
        self._futs = futs

    def resolve(self, timeout: float = 10.0) -> List[bool]:
        """Wait for every posted read; returns per-item success flags,
        parallel to the ``items`` given to ``prefetch_batch`` (``True``
        also for write-buffer hits). Donors that failed or timed out are
        struck (feeding eviction) exactly like the serial failover read;
        items reported ``False`` have NOT been filled and must take the
        ``swap_in`` replica-failover path."""
        errmaps: Dict[int, Optional[Dict]] = {}
        for donor, fut in self._futs.items():
            try:
                errmaps[donor] = fut.errors(timeout=timeout)
            except TimeoutError:
                errmaps[donor] = None   # whole vector still in flight
        out: List[bool] = []
        for slot in self._slots:
            if slot is True:
                out.append(True)
            elif slot is None:
                out.append(False)
            else:
                donor, remote = slot
                errs = errmaps[donor]
                ok = errs is not None and remote not in errs
                if ok:
                    self._paging._clear_strikes(donor)
                else:
                    self._paging._strike(donor)
                out.append(ok)
        return out
