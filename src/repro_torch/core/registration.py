"""Memory-region strategies: preMR staging, dynMR curves, and the MR cache.

Pieces that live here:

* ``StagingPool`` — pre-allocated, pre-registered MR buffers (the preMR
  path of §5.1): acquiring copies the payload in (the memcpy the paper
  prices), releasing returns the slab.
* ``cost_curves`` — the measured preMR-vs-dynMR cost data behind the
  Fig. 4 benchmark. The *decision* (cost crossover) lives in the NIC
  cost model and ``batching.resolve_reg_mode``.
* ``MRCache`` / ``MRConfig`` — registration-on-demand for the donor
  side. The engine's historical assumption (every donor page is
  pre-registered and pinned) caps heap size at registered memory; the
  MR cache drops it: a bounded map of *registered* pages, populated
  lazily on first touch. A served job whose pages are all registered is
  a **hit** and pays zero registration cost; any unregistered page is a
  **fault** — the serving NIC registers the missing pages under the
  region stripe locks (charging ``NICCostModel.reg_cost_us``), soft-
  fails the job RNR-style, and the client's existing bounded RNR retry
  machinery replays it against the now-warm extent. Eviction
  deregisters unpinned pages (dereg-on-evict), so residency is bounded
  while the heap behind it can be arbitrarily large.
* ``ExtentPrefetcher`` — NP-RDMA-style stream prediction: a per-client
  stride table with confidence counters turns sequential/strided fault
  patterns into *predicted* extents, which the donor NIC registers in
  the background (idle service workers only) so the demand access hits
  instead of faulting on the critical path.
* ``SLRUMRCache`` (policy ``slru``) and ``FreqExtentMRCache`` (policy
  ``freq-extent``) — replacement smarter than plain LRU: segmented LRU
  is scan-resistant (single-touch streams churn probation, reused pages
  live in a protected segment), and freq-extent picks whole-extent
  victims by (frequency, recency) so evicting part of a hot multi-page
  extent never orphans the rest.

Lock order matches the ``CacheTier`` invariant (docs/architecture.md):
region stripes → mr-cache lock, never the reverse. ``serve`` classifies
under the cache lock alone; the fault path releases it, takes the
extent's stripe locks, retakes the cache lock, and re-checks — so a
racing registration of the same extent downgrades the fault to a hit
instead of double-charging. ``prefetch_register`` follows the same
two-phase protocol, so a prefetch racing a demand fault resolves to
whichever got the stripe locks first, never a double registration.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import torch

from .buffers import ByteSpan, byte_view, copy_parts, host_bytes
from .descriptors import PAGE_SIZE, TransferDescriptor
from .errors import BoxError
from .nic import NICCostModel


class StagingPool:
    """Pre-allocated, pre-registered MR buffers (the preMR path).

    Fixed-size page-granular slabs; acquiring copies the payload in (the
    memcpy the paper prices), releasing returns the slab. ``acquire``
    blocks while every slab is checked out; pass ``timeout`` (real
    seconds) to fail with ``BoxError`` instead of waiting forever on a
    leaked pool. ``snapshot`` surfaces the acquire/contention counters.
    Slabs are host memory allocated once here, pinned (``pin_memory``)
    when the payloads come from the card, so nothing pins per transfer.
    """

    def __init__(self, slab_pages: int = 64, num_slabs: int = 32,
                 pin_memory: bool = False) -> None:
        self.slab_pages = slab_pages
        self.num_slabs = num_slabs
        self._free: List[torch.Tensor] = [
            host_bytes(slab_pages * PAGE_SIZE, pin_memory)
            for _ in range(num_slabs)
        ]
        self._cv = threading.Condition()
        self._acquires = 0
        self._waits = 0          # acquires that found no free slab

    def acquire(self, payload: torch.Tensor,
                timeout: Optional[float] = None) -> torch.Tensor:
        if payload.nbytes > self.slab_pages * PAGE_SIZE:
            raise ValueError(f"payload of {payload.nbytes} bytes exceeds a "
                             f"{self.slab_pages * PAGE_SIZE}-byte slab")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._acquires += 1
            if not self._free:
                self._waits += 1
            while not self._free:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise BoxError(
                        f"StagingPool.acquire timed out after {timeout}s: "
                        f"all {self.num_slabs} slabs checked out (leaked "
                        f"slab, or the pool is undersized for the load)")
                self._cv.wait(remaining)
            slab = self._free.pop()
        copy_parts([(ByteSpan(slab, 0, payload.nbytes), byte_view(payload))])
        return slab

    def release(self, slab: torch.Tensor) -> None:
        with self._cv:
            self._free.append(slab)
            self._cv.notify()

    def snapshot(self) -> Dict[str, int]:
        with self._cv:
            return {"slabs": self.num_slabs, "slab_pages": self.slab_pages,
                    "free": len(self._free), "acquires": self._acquires,
                    "waits": self._waits}


def cost_curves(cost: NICCostModel, sizes_kb: List[int]
                ) -> Dict[str, List[Tuple[int, float, float]]]:
    """(size_kb, preMR_us, dynMR_us) per space — the Fig. 4 data."""
    out: Dict[str, List[Tuple[int, float, float]]] = {"kernel": [], "user": []}
    for kb in sizes_kb:
        pages = max(1, (kb * 1024) // PAGE_SIZE)
        pre = cost.memcpy_cost_us(pages)
        out["kernel"].append((kb, pre, cost.reg_cost_us(pages, True)))
        out["user"].append((kb, pre, cost.reg_cost_us(pages, False)))
    return out


class ExtentPrefetcher:
    """Per-client stride-stream predictor for MR prefetch (NP-RDMA-ish).

    One stream per client: ``observe(client, page, npages)`` computes the
    delta from the client's previous demand extent. A repeated delta
    builds confidence; once confidence reaches ``confidence`` the stream
    is *established* and the predictor emits up to ``degree`` predicted
    extents per observation, each ``npages`` long, stepping by the
    stride — never more than ``depth`` strides ahead of the demand
    access (the lookahead window), and never re-predicting ground it
    already covered (an ``ahead`` high-water mark per stream). Negative
    strides (descending scans) work symmetrically. A broken stride
    resets confidence and the high-water mark, so random traffic emits
    (almost) nothing — mispredictions are gated, not merely wasted.

    Not thread-safe on its own: the owning ``MRCache`` calls ``observe``
    under its cache lock.
    """

    def __init__(self, depth: int = 4, degree: int = 2,
                 confidence: int = 2) -> None:
        self.depth = max(1, depth)
        self.degree = max(1, degree)
        self.confidence = max(1, confidence)
        # client -> [last_page, stride, confidence, ahead_high_water]
        self._streams: Dict[int, List[int]] = {}

    def observe(self, client: int, page: int, npages: int
                ) -> List[Tuple[int, int]]:
        """Feed one demand extent; returns predicted ``(page, npages)``
        extents to prefetch (possibly empty)."""
        st = self._streams.get(client)
        if st is None:
            self._streams[client] = [page, 0, 0, page]
            return []
        last, stride, conf, ahead = st
        delta = page - last
        if delta == 0:
            return []           # same extent re-touched: no stream signal
        if delta == stride:
            conf += 1
        else:
            stride, conf, ahead = delta, 1, page
        st[0], st[1], st[2], st[3] = page, stride, conf, ahead
        if conf < self.confidence:
            st[3] = page
            return []
        # predict from the high-water mark (or the demand page, whichever
        # is further along the stride), up to `degree` extents per
        # observation and at most `depth` strides past the demand access
        sign = 1 if stride > 0 else -1
        base = ahead if (ahead - page) * sign > 0 else page
        out: List[Tuple[int, int]] = []
        nxt = base + stride
        while (len(out) < self.degree
               and abs(nxt - page) <= self.depth * abs(stride)):
            out.append((nxt, npages))
            nxt += stride
        if out:
            st[3] = out[-1][0]
        return out


class MRCache:
    """Bounded map of *registered* donor pages (registration-on-demand).

    Attached to a ``RemoteRegion`` as ``region.mr`` (by ``MRConfig.build``,
    via the ``mr`` policy registry); consulted by the serving NIC once
    per job before any bytes move:

    * **hit** — every page of the job's extents is registered: the pages
      are touched (replacement freshness), the job proceeds with zero
      registration cost.
    * **fault** — at least one page is unregistered: the cache registers
      every missing page under the extent's region stripe locks (the
      caller charges ``reg_cost_us`` for exactly those pages), *pins*
      each request's page range keyed by its ``wr_id``, and reports the
      fault; the NIC soft-fails the job ``RNR_RETRY_ERR`` and the
      client's bounded RNR retry machinery replays it. Pinned pages are
      exempt from eviction until their request replays, so a replay is
      guaranteed to hit — one fault per first touch, never a fault loop.
    * **pass** — an extent outside the region is left alone: the region
      access raises and the job fails ``REMOTE_ERR`` exactly as without
      a cache (registering unreachable pages, or retrying a permanent
      error, would be wrong twice over).

    Replacement is LRU over unpinned pages in this base class (policy
    ``lru``), deregistering victims (dereg-on-evict); subclasses swap
    the policy by overriding the ``*_locked`` hooks below. A whole
    extent is admitted after evicting down to make room — an extent
    larger than what is evictable transiently overflows ``capacity``
    rather than livelocking (residency returns below the bound as
    replays unpin and later registrations sweep).

    **Prefetch protocol** (used when an ``ExtentPrefetcher`` is
    attached): ``serve`` feeds each *first-touch* demand extent to the
    predictor — replays are skipped, they are the same logical access
    and would break the stride stream — and queues predicted extents;
    the NIC drains them via ``drain_predictions`` and registers each in
    the background with ``prefetch_register`` (idle service workers
    only). Prefetched pages are tracked until first demand touch
    (``useful``) or eviction untouched (``wasted``).

    Counters (pages unless noted): ``hits``/``misses`` classify served
    pages; ``faults``/``replays`` count jobs soft-failed / served after
    a fault; ``registrations``/``deregistrations`` count page map churn
    (background prefetch registrations included).
    """

    def __init__(self, region, capacity_pages: int,
                 prefetcher: Optional[ExtentPrefetcher] = None) -> None:
        self.region = region
        self.capacity = max(1, min(capacity_pages, region.num_pages))
        self.prefetcher = prefetcher
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._pin: Dict[int, int] = {}                 # page -> refcount
        self._faulted: Dict[int, Tuple[int, int]] = {}  # wr_id -> (page, n)
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._faults = 0
        self._replays = 0
        self._registrations = 0
        self._deregistrations = 0
        # prefetch bookkeeping: pages registered by prediction and not
        # yet demanded; candidate extents awaiting NIC pickup
        self._prefetched: Set[int] = set()
        self._pending_pf: List[Tuple[int, int]] = []
        self._pf_issued = 0
        self._pf_useful = 0
        self._pf_wasted = 0
        self._next_eid = 0      # registration-batch (extent) id source

    # ---- serve-path protocol (called by the donor NIC) -------------------
    def serve(self, desc: TransferDescriptor,
              client: Optional[int] = None) -> Tuple[bool, int]:
        """Consult the cache for one served job. Returns ``(fault,
        registered_pages)``: ``(False, 0)`` is a hit (or an out-of-range
        pass), ``(True, n)`` is a fault that registered ``n`` missing
        pages — the caller charges ``reg_cost_us(n)`` and fails the job
        ``RNR_RETRY_ERR`` so the client replays it. ``client`` keys the
        prefetcher's stride stream (None skips prediction)."""
        ranges = [(r.remote_addr, r.num_pages) for r in desc.requests] \
            or [(desc.remote_addr, desc.num_pages)]
        num_region = self.region.num_pages
        for page, n in ranges:
            if page < 0 or page + n > num_region:
                return False, 0     # pass: the region access will raise
        total = sum(n for _, n in ranges)
        with self._lock:
            if not self._missing_locked(ranges):
                self._hit_locked(desc, ranges, total, client)
                return False, 0
        # fault path: register under the region stripe locks (lock order:
        # region stripes -> mr lock), re-checking residency under both —
        # a racing fault of an overlapping extent may have registered it
        region = self.region
        stripes = sorted({s for page, n in ranges
                          for s in region._stripes_of(page, n)})
        region._acquire(stripes)
        try:
            with self._lock:
                missing = self._missing_locked(ranges)
                if not missing:
                    self._hit_locked(desc, ranges, total, client)
                    return False, 0
                self._register_extent_locked(missing)
                self._misses += total
                self._faults += 1
                for r in desc.requests:
                    if r.wr_id in self._faulted:
                        continue    # re-fault of a merged replay: pinned
                    # first touch of this request: feed the predictor
                    # (after registration, so candidates overlapping the
                    # fresh extent are filtered out)
                    self._observe_locked(client, r.remote_addr, r.num_pages)
                    self._faulted[r.wr_id] = (r.remote_addr, r.num_pages)
                    for k in range(r.num_pages):
                        p = r.remote_addr + k
                        self._pin[p] = self._pin.get(p, 0) + 1
                return True, len(missing)
        finally:
            region._release(stripes)

    def _missing_locked(self, ranges) -> List[int]:
        return [p for page, n in ranges
                for p in range(page, page + n)
                if not self._contains_locked(p)]

    def _hit_locked(self, desc, ranges, total: int,
                    client: Optional[int] = None) -> None:
        """Touch a fully-registered extent: replacement freshness, hit
        pages, replay resolution (unpin) for requests that faulted
        earlier, prefetch-usefulness credit, and stream observation for
        first-touch requests (replays are the same logical access and
        are NOT re-observed — they would arrive out of stream order and
        break the stride)."""
        self._hits += total
        replayed = False
        replayed_pages: Set[int] = set()
        for r in desc.requests:
            pinned = self._faulted.pop(r.wr_id, None)
            if pinned is None:
                self._observe_locked(client, r.remote_addr, r.num_pages)
                continue
            replayed = True
            page, n = pinned
            for k in range(n):
                p = page + k
                replayed_pages.add(p)
                left = self._pin.get(p, 0) - 1
                if left > 0:
                    self._pin[p] = left
                else:
                    self._pin.pop(p, None)
        if replayed:
            self._replays += 1
        for page, n in ranges:
            for p in range(page, page + n):
                if p in self._prefetched:
                    self._prefetched.discard(p)
                    self._pf_useful += 1
                # a replay touch is the faulting access arriving, not a
                # reuse: scan-resistant policies must not promote on it
                self._touch_locked(p, reuse=p not in replayed_pages)

    def _observe_locked(self, client: Optional[int], page: int,
                        n: int) -> None:
        """Feed one first-touch demand extent to the predictor and queue
        the in-region, not-fully-registered candidates it emits."""
        if self.prefetcher is None or client is None:
            return
        num_region = self.region.num_pages
        for cand, cn in self.prefetcher.observe(client, page, n):
            if cand < 0:
                continue
            if cand + cn > num_region:
                cn = num_region - cand
                if cn <= 0:
                    continue
            if not any(not self._contains_locked(p)
                       for p in range(cand, cand + cn)):
                continue        # fully registered already: nothing to do
            self._pending_pf.append((cand, cn))

    def _register_extent_locked(self, pages: List[int],
                                prefetched: bool = False) -> None:
        """Admit one registration batch (an *extent*): evict down to make
        room first — the batch itself is never a victim candidate — then
        insert every page. If nothing is evictable (all pinned), the
        batch transiently overflows ``capacity``."""
        need = len(pages)
        while self._resident_locked() + need > self.capacity:
            if not self._evict_some_locked():
                break
        self._next_eid += 1
        eid = self._next_eid
        for p in pages:
            self._insert_locked(p, eid)
            self._registrations += 1
            if prefetched:
                self._prefetched.add(p)
                self._pf_issued += 1

    def _drop_accounting_locked(self, page: int) -> None:
        """Shared eviction bookkeeping: dereg count + wasted-prefetch
        credit for pages evicted before their predicted demand arrived."""
        self._deregistrations += 1
        if page in self._prefetched:
            self._prefetched.discard(page)
            self._pf_wasted += 1

    # ---- replacement-policy hooks (override in subclasses; lock held) ----
    def _contains_locked(self, page: int) -> bool:
        return page in self._lru

    def _resident_locked(self) -> int:
        return len(self._lru)

    def _touch_locked(self, page: int, reuse: bool = True) -> None:
        self._lru.move_to_end(page)

    def _insert_locked(self, page: int, eid: int) -> None:
        self._lru[page] = None

    def _evict_some_locked(self) -> int:
        """Evict at least one unpinned page (whole-extent policies may
        evict several); returns pages deregistered, 0 if everything
        resident is pinned."""
        victim = next((p for p in self._lru if p not in self._pin), None)
        if victim is None:
            return 0
        del self._lru[victim]
        self._drop_accounting_locked(victim)
        return 1

    # ---- background-prefetch protocol (called by the donor NIC) ----------
    def drain_predictions(self) -> List[Tuple[int, int]]:
        """Pop the predicted extents queued since the last drain."""
        if not self._pending_pf:
            return []
        with self._lock:
            out, self._pending_pf = self._pending_pf, []
        return out

    def prefetch_register(self, page: int, n: int) -> int:
        """Register one predicted extent in the background. Same
        two-phase protocol as the fault path (region stripes → mr lock,
        re-check under both), no pinning, no fault accounting. Returns
        the pages actually registered — 0 when a demand fault (or
        another prefetch) won the race."""
        if page < 0:
            return 0
        n = min(n, self.region.num_pages - page)
        if n <= 0:
            return 0
        ranges = [(page, n)]
        with self._lock:
            if not self._missing_locked(ranges):
                return 0
        region = self.region
        stripes = sorted(region._stripes_of(page, n))
        region._acquire(stripes)
        try:
            with self._lock:
                missing = self._missing_locked(ranges)
                if not missing:
                    return 0
                self._register_extent_locked(missing, prefetched=True)
                return len(missing)
        finally:
            region._release(stripes)

    # ---- stats -----------------------------------------------------------
    @staticmethod
    def _prefetch_stats(issued: int = 0, useful: int = 0,
                        wasted: int = 0) -> Dict[str, object]:
        return {"issued": issued, "useful": useful, "wasted": wasted,
                "accuracy": useful / issued if issued else 0.0,
                "queued": 0, "bg_pu_us": 0.0}

    @staticmethod
    def disabled_snapshot() -> Dict[str, object]:
        """The zeroed shape a donor without an MR cache reports, so stats
        consumers can address ``service.mr.*`` unconditionally."""
        return {"capacity_pages": 0, "resident_pages": 0, "pinned_pages": 0,
                "hits": 0, "misses": 0, "faults": 0, "replays": 0,
                "registrations": 0, "deregistrations": 0, "hit_rate": 0.0,
                "prefetch": MRCache._prefetch_stats()}

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            hits, misses = self._hits, self._misses
            out = {
                "capacity_pages": self.capacity,
                "resident_pages": self._resident_locked(),
                "pinned_pages": len(self._pin),
                "hits": hits,
                "misses": misses,
                "faults": self._faults,
                "replays": self._replays,
                "registrations": self._registrations,
                "deregistrations": self._deregistrations,
                # queued/bg_pu_us are NIC-side facts; the NIC's
                # service_snapshot overwrites them
                "prefetch": self._prefetch_stats(
                    self._pf_issued, self._pf_useful, self._pf_wasted),
            }
        total = hits + misses
        out["hit_rate"] = hits / total if total else 0.0
        return out


class SLRUMRCache(MRCache):
    """Segmented-LRU replacement (policy ``slru``): scan-resistant.

    New extents enter a *probation* segment; a page re-used after its
    registering access is promoted to a *protected* segment bounded at
    ``protected_fraction`` of capacity (promotion overflow demotes the
    protected LRU back to probation MRU). Victims come from probation
    first, so a single-touch scan churns probation without flushing the
    re-used hot set — the failure mode plain LRU has under the MR cache's
    registration churn. Replay touches (the faulting access arriving)
    do NOT promote: a fault + its replay is one logical access.
    """

    def __init__(self, region, capacity_pages: int,
                 prefetcher: Optional[ExtentPrefetcher] = None,
                 protected_fraction: float = 0.8) -> None:
        super().__init__(region, capacity_pages, prefetcher=prefetcher)
        self.protected_cap = min(
            self.capacity,
            max(1, int(round(self.capacity * protected_fraction))))
        self._prob: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._prot: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    def _contains_locked(self, page: int) -> bool:
        return page in self._prob or page in self._prot

    def _resident_locked(self) -> int:
        return len(self._prob) + len(self._prot)

    def _insert_locked(self, page: int, eid: int) -> None:
        self._prob[page] = None

    def _touch_locked(self, page: int, reuse: bool = True) -> None:
        if page in self._prot:
            self._prot.move_to_end(page)
            return
        if not reuse:
            self._prob.move_to_end(page)
            return
        del self._prob[page]
        self._prot[page] = None
        while len(self._prot) > self.protected_cap:
            demoted, _ = self._prot.popitem(last=False)
            self._prob[demoted] = None      # demote to probation MRU

    def _evict_some_locked(self) -> int:
        for seg in (self._prob, self._prot):
            victim = next((p for p in seg if p not in self._pin), None)
            if victim is not None:
                del seg[victim]
                self._drop_accounting_locked(victim)
                return 1
        return 0

    def snapshot(self) -> Dict[str, object]:
        out = super().snapshot()
        with self._lock:
            out["probation_pages"] = len(self._prob)
            out["protected_pages"] = len(self._prot)
        return out


class FreqExtentMRCache(MRCache):
    """Frequency-aware whole-extent replacement (policy ``freq-extent``).

    Pages registered together (one fault, or one prefetched prediction)
    form an *extent*; touches bump the extent's frequency (demand page-
    touches; replay touches refresh recency only). The victim is the
    whole least-(frequency, recency) extent with no pinned page — all
    its pages deregister together, so a hot multi-page extent is never
    left partially registered (which would turn its next access into a
    fault for the orphaned remainder).
    """

    def __init__(self, region, capacity_pages: int,
                 prefetcher: Optional[ExtentPrefetcher] = None) -> None:
        super().__init__(region, capacity_pages, prefetcher=prefetcher)
        self._page_ext: Dict[int, int] = {}        # page -> extent id
        # eid -> [pages set, frequency, last-touch seq]
        self._extents: Dict[int, List] = {}
        self._touch_seq = 0

    def _contains_locked(self, page: int) -> bool:
        return page in self._page_ext

    def _resident_locked(self) -> int:
        return len(self._page_ext)

    def _insert_locked(self, page: int, eid: int) -> None:
        ext = self._extents.get(eid)
        if ext is None:
            self._touch_seq += 1
            ext = self._extents[eid] = [set(), 1, self._touch_seq]
        ext[0].add(page)
        self._page_ext[page] = eid

    def _touch_locked(self, page: int, reuse: bool = True) -> None:
        ext = self._extents[self._page_ext[page]]
        self._touch_seq += 1
        ext[2] = self._touch_seq
        if reuse:
            ext[1] += 1

    def _evict_some_locked(self) -> int:
        best_key = None
        best_eid = None
        pin = self._pin
        for eid, (pages, freq, seq) in self._extents.items():
            if any(p in pin for p in pages):
                continue        # pinned extents survive whole
            key = (freq, seq)
            if best_key is None or key < best_key:
                best_key, best_eid = key, eid
        if best_eid is None:
            return 0
        pages, _, _ = self._extents.pop(best_eid)
        for p in pages:
            del self._page_ext[p]
            self._drop_accounting_locked(p)
        return len(pages)

    def snapshot(self) -> Dict[str, object]:
        out = super().snapshot()
        with self._lock:
            out["extents"] = len(self._extents)
        return out


@dataclass
class MRConfig:
    """The ``mr`` policy kind (built-in names: ``lru``, ``slru``,
    ``freq-extent``).

    ``capacity_pages=0`` (the default) disables the cache entirely —
    donors serve every page as pre-registered, exactly the pre-MR-cache
    behavior (and charges). ``ClusterSpec.registered_pages`` overrides
    the capacity without replacing the policy, mirroring
    ``donor_cache_pages`` on the cache policy; ``ClusterSpec.mr_prefetch``
    likewise overrides the prefetch knobs. ``prefetch_depth=0`` (the
    default) disables prediction — the serve path then reproduces the
    plain registration-on-demand charges exactly. Custom mr policies
    registered via ``@register_policy`` must provide
    ``build(region) -> Optional[MRCache-like]``.
    """

    capacity_pages: int = 0       # 0 disables the cache
    prefetch_depth: int = 0       # lookahead in strides; 0 disables
    prefetch_degree: int = 2      # predicted extents per trigger
    prefetch_confidence: int = 2  # repeated strides before predicting

    def build(self, region) -> Optional[MRCache]:
        if self.capacity_pages <= 0:
            return None
        pf = None
        if self.prefetch_depth > 0:
            pf = ExtentPrefetcher(depth=self.prefetch_depth,
                                  degree=self.prefetch_degree,
                                  confidence=self.prefetch_confidence)
        return self._make(region, pf)

    def _make(self, region, pf: Optional[ExtentPrefetcher]) -> MRCache:
        return MRCache(region, self.capacity_pages, prefetcher=pf)


@dataclass
class SLRUConfig(MRConfig):
    """The ``slru`` mr policy: segmented LRU, scan-resistant.
    ``protected_fraction`` bounds the protected segment."""

    protected_fraction: float = 0.8

    def _make(self, region, pf: Optional[ExtentPrefetcher]) -> MRCache:
        return SLRUMRCache(region, self.capacity_pages, prefetcher=pf,
                           protected_fraction=self.protected_fraction)


@dataclass
class FreqExtentConfig(MRConfig):
    """The ``freq-extent`` mr policy: frequency-aware whole-extent
    victims."""

    def _make(self, region, pf: Optional[ExtentPrefetcher]) -> MRCache:
        return FreqExtentMRCache(region, self.capacity_pages, prefetcher=pf)
