"""Remote memory regions — page-granular byte arrays donated by peer nodes.

This is the "remote MR" the simulated fabric reads/writes. Data movement is
real (torch ``copy_``s), so paging/offload correctness is end-to-end
testable. A region is host memory (it stands for another machine's DRAM),
pinned when the session's device is CUDA; the client side of a copy may
lie on any device.

Concurrency: the region is striped into ``lock_stripes`` page ranges, each
with its own lock. An access holds exactly the stripes its page range
covers (acquired in index order, so overlapping accesses cannot deadlock),
letting transfers to disjoint parts of a donor region proceed in parallel
instead of serializing on one whole-region lock. The vectorized entry
points (``writev``/``readv``) take the union of their parts' stripes once,
so a merged multi-run descriptor pays a single lock round trip.

Hot-page cache tier (RDCA-style last mile): a donor region may carry a
bounded ``CacheTier`` mirroring its hottest pages — the model of
SmartNIC/LLC-resident data the receive side can serve without touching
host memory. The tier is *consulted* by the serving NIC (reads hit the
mirror at a reduced service cost) but *kept coherent* here, at the one
choke point every write path shares: ``write``/``writev`` invoke the
tier's write hook while still holding the written pages' stripe locks,
so a cached page is written through (the mirror can never go stale) and
an uncached write invalidates any pending promotion credit. Lock order
is always region stripes → tier lock, never the reverse.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .buffers import copy_parts, host_bytes
from .descriptors import PAGE_SIZE


class RemoteAccessError(IndexError, KeyError):
    """A remote access fault: pages outside a donor's region, or a node
    that donated no region. The only exception of a byte move that
    becomes a REMOTE_ERR completion; any other (a failed device copy, a
    host-side bug) reaches the caller as itself. An ``IndexError`` and a
    ``KeyError``, so callers of the region and the directory catch it as
    they would the reference's."""


class RemoteRegion:
    """One donor node's registered memory region."""

    def __init__(self, node_id: int, num_pages: int,
                 lock_stripes: int = 16, pin_memory: bool = False) -> None:
        self.node_id = node_id
        self.num_pages = num_pages
        self._mem = host_bytes((num_pages, PAGE_SIZE), pin_memory)
        stripes = max(1, min(lock_stripes, num_pages))
        self._stripe_pages = -(-num_pages // stripes)       # ceil
        self._locks = [threading.Lock() for _ in range(stripes)]
        # optional hot-page fast tier (attached by the fabric when the
        # cluster enables donor caching); every write path below notifies
        # it under the stripe locks, so it can never serve stale bytes
        self.cache: Optional["CacheTier"] = None
        # optional MR cache (core.registration.MRCache, attached by the
        # fabric when the cluster enables registration-on-demand): the
        # serving NIC consults it before moving bytes — unregistered
        # pages fault (register + RNR replay) instead of being free.
        # Duck-typed to keep region <- registration import-free; same
        # lock-order invariant as the tier: region stripes -> mr lock.
        self.mr = None

    # ---- striped locking -------------------------------------------------
    def _stripes_of(self, page: int, num_pages: int) -> range:
        return range(page // self._stripe_pages,
                     (page + num_pages - 1) // self._stripe_pages + 1)

    def _acquire(self, stripes: Sequence[int]) -> None:
        for i in stripes:               # ascending order: deadlock-free
            self._locks[i].acquire()

    def _release(self, stripes: Sequence[int]) -> None:
        for i in reversed(stripes):
            self._locks[i].release()

    def _check(self, page: int, num_pages: int, what: str) -> None:
        if page < 0 or page + num_pages > self.num_pages:
            raise RemoteAccessError(
                f"remote {what} [{page},{page + num_pages}) "
                f"outside region of {self.num_pages} pages")

    # ---- scalar API ------------------------------------------------------
    def write(self, page: int, data: torch.Tensor) -> None:
        n = data.numel() // PAGE_SIZE
        self._check(page, n, "write")
        stripes = list(self._stripes_of(page, n))
        self._acquire(stripes)
        try:
            copy_parts([(self._mem[page : page + n], data)])
            if self.cache is not None:
                self.cache.on_write([(page, data, n)])
        finally:
            self._release(stripes)

    def read(self, page: int, num_pages: int) -> torch.Tensor:
        """Read into a fresh host buffer (allocates; prefer ``read_into``)."""
        out = torch.empty((num_pages, PAGE_SIZE), dtype=torch.uint8)
        self.read_into(page, num_pages, out)
        return out

    def read_into(self, page: int, num_pages: int, out: torch.Tensor) -> None:
        """Zero-copy read: one ``copy_`` straight into the caller's buffer
        (any shape of ``num_pages * PAGE_SIZE`` bytes, on any device), no
        intermediate allocation."""
        self._check(page, num_pages, "read")
        stripes = list(self._stripes_of(page, num_pages))
        self._acquire(stripes)
        try:
            copy_parts([(out, self._mem[page : page + num_pages])])
        finally:
            self._release(stripes)

    # ---- vectorized API (one lock round per descriptor) ------------------
    def writev(self, parts: Sequence[Tuple[int, torch.Tensor]]) -> None:
        """Scatter-write many (page, data) parts under ONE acquisition of
        the union of their lock stripes."""
        if not parts:
            return
        sizes = [(p, d, d.numel() // PAGE_SIZE) for p, d in parts]
        stripes: set = set()
        for page, _, n in sizes:
            self._check(page, n, "write")
            stripes.update(self._stripes_of(page, n))
        ordered = sorted(stripes)
        self._acquire(ordered)
        try:
            copy_parts((self._mem[page : page + n], data)
                       for page, data, n in sizes)
            if self.cache is not None:
                self.cache.on_write(sizes)
        finally:
            self._release(ordered)

    def readv(self, parts: Sequence[Tuple[int, int, torch.Tensor]]) -> None:
        """Gather-read many (page, num_pages, out) parts under one
        acquisition of the union of their lock stripes; each part is one
        ``copy_`` into its caller-provided buffer."""
        if not parts:
            return
        stripes: set = set()
        for page, n, _ in parts:
            self._check(page, n, "read")
            stripes.update(self._stripes_of(page, n))
        ordered = sorted(stripes)
        self._acquire(ordered)
        try:
            copy_parts((out, self._mem[page : page + n])
                       for page, n, out in parts)
        finally:
            self._release(ordered)

    @property
    def nbytes(self) -> int:
        return self.num_pages * PAGE_SIZE


class CacheTier:
    """Bounded mirror of a donor region's hottest pages.

    Models the RDCA "last mile": a small SmartNIC/LLC-resident tier the
    receive side serves hits from without paying host-memory (region)
    bandwidth. Promotion is frequency-based — an uncached page earns one
    credit per read access and is promoted once it accumulates
    ``promote_after`` — and eviction is CLOCK (second chance): frames
    carry a reference bit, set on every hit, that buys one sweep of grace
    before the hand reclaims the frame.

    Coherence contract (the part that lets the tier serve *bytes*, not
    just a cost discount):

    * ``on_write`` is called by the owning region's write paths while
      they still hold the written pages' stripe locks. A cached page is
      written through — the mirror is updated in place and stays hot; an
      uncached page loses its pending promotion credit (the accesses that
      earned it saw bytes that no longer exist) and counts an
      invalidation.
    * ``promote`` copies the page under its region stripe lock, so a
      concurrent write can never leave a torn or stale frame.
    * Read hits (``read_into``) copy out of the mirror, so a coherence
      bug surfaces as wrong bytes in tests, not as a silent cost error.

    Lock order is region stripes → tier lock everywhere; the tier never
    acquires a stripe while holding its own lock (``begin_reads`` returns
    the pages to promote instead of promoting them inline).
    """

    def __init__(self, region: RemoteRegion, capacity_pages: int,
                 promote_after: int = 2) -> None:
        self.region = region
        self.capacity = max(1, min(capacity_pages, region.num_pages))
        self.promote_after = max(1, promote_after)
        self._frames = host_bytes((self.capacity, PAGE_SIZE),
                                  region._mem.is_pinned())
        self._frame_of: Dict[int, int] = {}      # page -> frame
        self._page_of: List[Optional[int]] = [None] * self.capacity
        self._ref: List[bool] = [False] * self.capacity
        self._free: List[int] = list(range(self.capacity))
        self._hand = 0
        self._pending: Dict[int, int] = {}       # page -> access credit
        self._lock = threading.Lock()
        self._hits = 0            # counters in PAGES (read-serving only)
        self._misses = 0
        self._promotions = 0
        self._evictions = 0
        self._invalidations = 0
        self._write_throughs = 0

    # ---- read path (called by the serving NIC) ---------------------------
    def begin_reads(self, parts: Sequence[Tuple[int, int, torch.Tensor]]
                    ) -> Tuple[List[bool], List[int]]:
        """Classify read parts in one lock round: returns (hit flags
        parallel to ``parts``, pages that just crossed the promotion
        threshold). A part hits only when EVERY page of its range is
        resident — partially-resident multi-page reads are served from
        the region (and counted as misses). Missed pages earn promotion
        credit; the caller performs the returned promotions *after*
        releasing any region locks (``promote`` takes stripes itself)."""
        num_pages = self.region.num_pages
        flags: List[bool] = []
        promote: List[int] = []
        with self._lock:
            for page, n, _ in parts:
                if page < 0 or page + n > num_pages:
                    flags.append(False)     # bound error: the region read
                    self._misses += n       # will raise, don't track it
                    continue
                resident = all(page + k in self._frame_of for k in range(n))
                flags.append(resident)
                if resident:
                    self._hits += n
                    for k in range(n):
                        self._ref[self._frame_of[page + k]] = True
                    continue
                self._misses += n
                for k in range(n):
                    p = page + k
                    if p in self._frame_of:
                        continue            # resident page of a mixed range
                    credit = self._pending.get(p, 0) + 1
                    if credit >= self.promote_after:
                        self._pending.pop(p, None)
                        promote.append(p)
                    else:
                        self._pending[p] = credit
        return flags, promote

    def read_into(self, page: int, n: int, out: torch.Tensor) -> bool:
        """Serve a hit from the mirror. Returns False when any page was
        evicted between classification and service (the caller falls back
        to the region — the bytes are identical, only the charge was
        already taken as a hit)."""
        with self._lock:
            try:
                frames = [self._frame_of[page + k] for k in range(n)]
            except KeyError:
                return False
            copy_parts([(out, self._frames[frames])])
            return True

    def promote(self, page: int) -> None:
        """Install one page, copying under its region stripe lock so a
        concurrent write cannot tear the frame. Idempotent — a racing
        promotion of the same page is a no-op."""
        r = self.region
        if not 0 <= page < r.num_pages:
            return
        stripes = list(r._stripes_of(page, 1))
        r._acquire(stripes)
        try:
            with self._lock:
                if page in self._frame_of:
                    return
                frame = self._victim_locked()
                self._frames[frame].copy_(r._mem[page])
                self._frame_of[page] = frame
                self._page_of[frame] = page
                self._ref[frame] = True     # one CLOCK sweep of grace
                self._promotions += 1
        finally:
            r._release(stripes)

    def _victim_locked(self) -> int:
        if self._free:
            return self._free.pop()
        while True:
            f = self._hand
            self._hand = (self._hand + 1) % self.capacity
            if self._ref[f]:
                self._ref[f] = False        # second chance
                continue
            old = self._page_of[f]
            if old is not None:
                del self._frame_of[old]
                self._page_of[f] = None
                self._evictions += 1
            return f

    # ---- write-path coherence hook ---------------------------------------
    def on_write(self, sized_parts: Sequence[Tuple[int, torch.Tensor, int]]
                 ) -> None:
        """Called by the region's write paths WITH the written pages'
        stripe locks held: write-through for cached pages, promotion-
        credit invalidation for uncached ones."""
        with self._lock:
            through = []
            for page, data, n in sized_parts:
                rows = data.reshape(n, PAGE_SIZE)
                for k in range(n):
                    frame = self._frame_of.get(page + k)
                    if frame is not None:
                        through.append((self._frames[frame], rows[k]))
                        self._write_throughs += 1
                    elif self._pending.pop(page + k, None) is not None:
                        self._invalidations += 1
            copy_parts(through)

    # ---- stats -----------------------------------------------------------
    @staticmethod
    def disabled_snapshot() -> Dict[str, object]:
        """The zeroed shape a donor without a tier reports, so stats
        consumers can address ``service.cache.*`` unconditionally."""
        return {"capacity_pages": 0, "resident_pages": 0, "hits": 0,
                "misses": 0, "promotions": 0, "evictions": 0,
                "invalidations": 0, "write_throughs": 0, "hit_rate": 0.0}

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            hits, misses = self._hits, self._misses
            out = {
                "capacity_pages": self.capacity,
                "resident_pages": len(self._frame_of),
                "hits": hits,
                "misses": misses,
                "promotions": self._promotions,
                "evictions": self._evictions,
                "invalidations": self._invalidations,
                "write_throughs": self._write_throughs,
            }
        total = hits + misses
        out["hit_rate"] = hits / total if total else 0.0
        return out


@dataclass
class CacheConfig:
    """The ``cache`` policy kind (built-in name: ``freq-clock``).

    ``capacity_pages=0`` (the default) disables the tier entirely —
    donors serve every page from the region exactly as before.
    ``ClusterSpec.donor_cache_pages`` overrides the capacity without
    replacing the policy, mirroring ``serve_workers`` on the service
    policy. Custom cache policies registered via ``@register_policy``
    must provide ``build(region) -> Optional[CacheTier-like]``.
    """

    capacity_pages: int = 0       # 0 disables the tier
    promote_after: int = 2        # read accesses before promotion

    def build(self, region: RemoteRegion) -> Optional[CacheTier]:
        if self.capacity_pages <= 0:
            return None
        return CacheTier(region, self.capacity_pages,
                         promote_after=self.promote_after)


class RegionDirectory:
    """Cluster-wide directory of donated regions (exchange of rkeys/addrs)."""

    def __init__(self) -> None:
        self._regions: Dict[int, RemoteRegion] = {}

    def register(self, region: RemoteRegion) -> None:
        self._regions[region.node_id] = region

    def lookup(self, node_id: int) -> RemoteRegion:
        try:
            return self._regions[node_id]
        except KeyError:
            raise RemoteAccessError(
                f"node {node_id} donated no region") from None

    def get(self, node_id: int) -> Optional[RemoteRegion]:
        return self._regions.get(node_id)

    def __contains__(self, node_id: int) -> bool:
        return node_id in self._regions

    def nodes(self):
        return sorted(self._regions)
