"""Typed capability objects handed out by a ``Session``.

Every handle borrows the session's lifetime: closing the session closes
its children, and any use after close raises ``ClosedError``. All data
paths ride the engine's batched zero-copy hot path and return the same
``TransferFuture``/``BatchFuture`` objects the engine uses internally, so
error handling is uniform across heap, paging, tensor, and KV tiers.

* ``RemoteHeap.alloc(nbytes) -> RemoteBuffer`` — handle-based remote
  memory: a contiguous page range on one donor, with
  ``write``/``read_into`` (one WR) and ``writev``/``readv`` (one batch
  vector) plus sync ``read``.
* ``Pager`` — the replicated remote paging system (swap_out/swap_in,
  batch variants, failover knobs).
* ``TensorStore`` — tensor/pytree offload (training-state tier).
* ``KVStore`` — the paged KV cache with remote spill, its arena carved
  from the client's heap slice.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.descriptors import PAGE_SIZE
from ..core.errors import AllocError, ClosedError
from ..core.paging import RemotePagingSystem
from ..core.rdmabox import BatchFuture, RDMABox, TransferFuture
from ..memory.kv_cache import PagedKVCache
from ..memory.offload import OffloadConfig, OffloadManager


class _Capability:
    """Shared lifetime guard: valid while the owning session is open."""

    def __init__(self, session) -> None:
        self._session = session

    def _guard(self) -> None:
        if self._session.closed:
            raise ClosedError(
                f"{type(self).__name__} used after its session closed")


class SpanAllocator:
    """First-fit allocator over one donor's heap page range.

    Free spans are kept sorted and coalesced on free; allocations are
    contiguous (a ``RemoteBuffer`` is one remote page run, which is what
    keeps its ``writev``/``readv`` vectors mergeable into few WQEs).
    """

    def __init__(self, base: int, num_pages: int) -> None:
        self.base = base
        self.num_pages = num_pages
        self._free: List[Tuple[int, int]] = (
            [(base, num_pages)] if num_pages > 0 else [])
        self.free_pages = num_pages

    def alloc(self, n: int) -> Optional[int]:
        for i, (start, length) in enumerate(self._free):
            if length >= n:
                if length == n:
                    self._free.pop(i)
                else:
                    self._free[i] = (start + n, length - n)
                self.free_pages -= n
                return start
        return None

    def alloc_at(self, start: int, n: int) -> bool:
        """Carve the exact range [start, start+n) out of a free span;
        False when any of it is already taken."""
        for i, (s, ln) in enumerate(self._free):
            if s <= start and start + n <= s + ln:
                pieces = []
                if start > s:
                    pieces.append((s, start - s))
                if s + ln > start + n:
                    pieces.append((start + n, s + ln - (start + n)))
                self._free[i:i + 1] = pieces
                self.free_pages -= n
                return True
        return False

    def free(self, start: int, n: int) -> None:
        self._free.append((start, n))
        self._free.sort()
        merged: List[Tuple[int, int]] = []
        for s, ln in self._free:        # coalesce adjacent spans
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((s, ln))
        self._free = merged
        self.free_pages += n

    def largest_span(self) -> int:
        return max((ln for _, ln in self._free), default=0)


class RemoteBuffer(_Capability):
    """A contiguous remote page range on one donor, owned by the caller.

    Payload sizes are page-granular (the engine's block-I/O invariant):
    ``data.nbytes`` must be a multiple of ``PAGE_SIZE``. Buffers are
    referenced, not copied, until the NIC moves them (zero-copy).
    """

    def __init__(self, heap: "RemoteHeap", donor: int, base_page: int,
                 num_pages: int) -> None:
        super().__init__(heap._session)
        self._heap = heap
        self.donor = donor
        self.base_page = base_page
        self.num_pages = num_pages
        self._freed = False

    @property
    def nbytes(self) -> int:
        return self.num_pages * PAGE_SIZE

    def _guard(self) -> None:
        if self._freed:
            raise ClosedError("RemoteBuffer used after free()")
        super()._guard()

    def _check(self, page_offset: int, num_pages: int, what: str) -> None:
        if page_offset < 0 or page_offset + num_pages > self.num_pages:
            raise AllocError(
                f"{what} [{page_offset}, {page_offset + num_pages}) outside "
                f"buffer of {self.num_pages} pages")

    @staticmethod
    def _pages_of(arr: torch.Tensor, what: str) -> int:
        if arr.nbytes == 0 or arr.nbytes % PAGE_SIZE:
            raise ValueError(f"{what} payload must be a non-empty multiple "
                             f"of PAGE_SIZE, got {arr.nbytes} bytes")
        return arr.nbytes // PAGE_SIZE

    # ---- one-WR paths ------------------------------------------------------
    def write(self, data: torch.Tensor, page_offset: int = 0) -> TransferFuture:
        """Async write of ``data`` at ``page_offset``; one WorkRequest.

        Raises ``ValueError`` on a payload that is not a non-empty
        multiple of ``PAGE_SIZE`` and ``AllocError`` when the page range
        falls outside the buffer; the returned future's ``wait`` raises
        ``TransferError`` on a failed transfer."""
        self._guard()
        n = self._pages_of(data, "write")
        self._check(page_offset, n, "write")
        return self._heap._box.write(self.donor, self.base_page + page_offset,
                                     data, num_pages=n)

    def read_into(self, out: torch.Tensor,
                  page_offset: int = 0) -> TransferFuture:
        """Async read at ``page_offset`` straight into ``out`` (same
        payload/range/failure contract as ``write``)."""
        self._guard()
        n = self._pages_of(out, "read")
        self._check(page_offset, n, "read")
        return self._heap._box.read(self.donor, self.base_page + page_offset,
                                    n, out=out)

    def read(self, page_offset: int = 0, num_pages: Optional[int] = None,
             timeout: float = 30.0) -> torch.Tensor:
        """Sync read returning a fresh byte buffer on the session's
        device."""
        n = self.num_pages - page_offset if num_pages is None else num_pages
        out = torch.empty(n * PAGE_SIZE, dtype=torch.uint8,
                          device=self._heap._box.device)
        self.read_into(out, page_offset=page_offset).wait(timeout)
        return out

    # ---- batch-vector paths ------------------------------------------------
    def writev(self, items: Sequence[Tuple[int, torch.Tensor]]) -> BatchFuture:
        """One batched write vector of (page_offset, data) pairs — a
        single merge-queue lock acquisition, ONE future for the vector.
        The future's ``wait`` raises ``BatchTransferError`` naming every
        failed page; ``errors`` returns the per-page map instead."""
        self._guard()
        pairs = []
        for off, data in items:
            n = self._pages_of(data, "writev")
            self._check(off, n, "writev")
            pairs.append((self.base_page + off, data))
        return self._heap._box.write_pages(self.donor, pairs)

    def readv(self, items: Sequence[Tuple[int, torch.Tensor]]) -> BatchFuture:
        """One batched read vector; donor copies land straight in the
        caller's buffers."""
        self._guard()
        pairs = []
        for off, out in items:
            n = self._pages_of(out, "readv")
            self._check(off, n, "readv")
            pairs.append((self.base_page + off, out))
        return self._heap._box.read_pages(self.donor, pairs)

    def free(self) -> None:
        """Return the page range to the heap (idempotent)."""
        if self._freed:
            return
        self._freed = True
        self._heap._release(self)


class RemoteHeap(_Capability):
    """Handle-based remote memory for one client: ``alloc`` carves
    contiguous page ranges out of the client's heap slice of each donor
    region (round-robin across donors, first donor with a fitting span).
    Requires ``ClusterSpec.heap_pages > 0``.
    """

    def __init__(self, session, box: RDMABox, donors: List[int],
                 heap_base: int, heap_pages: int) -> None:
        super().__init__(session)
        self._box = box
        self._donors = list(donors)
        self._allocs = {d: SpanAllocator(heap_base, heap_pages)
                        for d in self._donors}
        self._lock = threading.Lock()
        self._cursor = 0
        self.heap_pages = heap_pages
        self.allocated = 0              # live buffers

    def alloc(self, nbytes: int) -> RemoteBuffer:
        """Allocate ``ceil(nbytes / PAGE_SIZE)`` contiguous remote pages;
        raises ``AllocError`` when no donor has a fitting span."""
        self._guard()
        if nbytes <= 0:
            raise AllocError(f"alloc({nbytes}): size must be positive")
        n = -(-nbytes // PAGE_SIZE)
        with self._lock:
            for i in range(len(self._donors)):
                donor = self._donors[(self._cursor + i) % len(self._donors)]
                base = self._allocs[donor].alloc(n)
                if base is not None:
                    self._cursor = (self._cursor + i + 1) % len(self._donors)
                    self.allocated += 1
                    return RemoteBuffer(self, donor, base, n)
            spans = {d: a.largest_span() for d, a in self._allocs.items()}
        raise AllocError(
            f"remote heap exhausted: need {n} contiguous pages, largest "
            f"free span per donor: {spans} (heap_pages={self.heap_pages})")

    def reserve_range(self, num_pages: int) -> int:
        """Reserve the SAME contiguous page range on EVERY donor (the KV
        spill arena needs donor-agnostic remote indices). All-or-nothing;
        raises ``AllocError`` when no common range exists. Reserved pages
        never collide with ``alloc`` buffers."""
        self._guard()
        if num_pages <= 0:
            raise AllocError(f"reserve_range({num_pages}): must be positive")
        with self._lock:
            first = self._allocs[self._donors[0]]
            for base, length in list(first._free):
                if length < num_pages:
                    continue
                taken = []
                for d in self._donors:
                    if self._allocs[d].alloc_at(base, num_pages):
                        taken.append(d)
                    else:
                        break
                if len(taken) == len(self._donors):
                    return base
                for d in taken:         # roll the partial reservation back
                    self._allocs[d].free(base, num_pages)
            spans = {d: a.largest_span() for d, a in self._allocs.items()}
        raise AllocError(
            f"no common {num_pages}-page range free on every donor "
            f"(largest free span per donor: {spans})")

    def _release(self, buf: RemoteBuffer) -> None:
        with self._lock:
            self._allocs[buf.donor].free(buf.base_page, buf.num_pages)
            self.allocated -= 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "heap_pages": self.heap_pages,
                "live_buffers": self.allocated,
                "free_pages": {d: a.free_pages
                               for d, a in self._allocs.items()},
            }


class Pager(_Capability):
    """Capability view of one client's replicated remote paging system.

    Pages are ``PAGE_SIZE``-byte units addressed by ``page_id`` in
    ``[0, capacity_pages)``. Writes replicate to ``spec.replication``
    donors; reads fail over replica → first-responder → disk before an
    error ever surfaces. All methods raise ``ClosedError`` after the
    owning session closes.
    """

    def __init__(self, session, paging: RemotePagingSystem) -> None:
        super().__init__(session)
        self._paging = paging

    @property
    def capacity_pages(self) -> int:
        """Addressable pages (placement-dependent, < the region slice)."""
        return self._paging.capacity_pages

    def swap_out(self, page_id: int, data: torch.Tensor, wait: bool = False,
                 timeout: float = 30.0) -> List[TransferFuture]:
        """Write one page to every replica.

        Returns one future per replica write (already waited on when
        ``wait=True``). Raises ``TransferError`` (via ``wait``) when a
        replica write fails past the engine's RNR retries."""
        self._guard()
        return self._paging.swap_out(page_id, data, wait=wait,
                                     timeout=timeout)

    def swap_out_batch(self, items: List[Tuple[int, torch.Tensor]],
                       timeout: float = 30.0,
                       wait: bool = True) -> List[BatchFuture]:
        """Batched swap-out of (page_id, data) pairs — one coalesced
        write vector per touched donor, one ``BatchFuture`` each."""
        self._guard()
        return self._paging.swap_out_batch(items, timeout=timeout, wait=wait)

    def swap_in(self, page_id: int, timeout: float = 10.0) -> torch.Tensor:
        """Read one page back (fresh buffer), trying replicas in order
        and falling back to disk only when ALL replicas failed. An
        in-flight async swap-out of the same page is served locally from
        the write buffer. Raises ``KeyError`` for a never-written page."""
        self._guard()
        return self._paging.swap_in(page_id, timeout=timeout)

    def prefetch(self, page_id: int, out: torch.Tensor) -> TransferFuture:
        """Async read of one page straight into ``out`` (no failover —
        the caller inspects the future)."""
        self._guard()
        return self._paging.prefetch(page_id, out)

    def prefetch_batch(self, items: List[Tuple[int, torch.Tensor]]):
        """Batched prefetch of (page_id, out-buffer) pairs; returns a
        handle whose ``wait()`` resolves every read."""
        self._guard()
        return self._paging.prefetch_batch(items)

    def replicas(self, page_id: int) -> List[Tuple[int, int]]:
        """The (donor_node, donor_page) placement of every replica."""
        return self._paging.replicas(page_id)

    def fail_node(self, node: int) -> None:
        """Strike a donor: reads skip it, writes stop targeting it."""
        self._guard()
        self._paging.fail_node(node)

    def recover_node(self, node: int) -> None:
        """Clear a strike set by ``fail_node`` (or crash detection)."""
        self._guard()
        self._paging.recover_node(node)

    def snapshot(self) -> Dict[str, object]:
        return self._paging.snapshot()

    stats = snapshot                    # legacy accessor name


class TensorStore(OffloadManager, _Capability):
    """Tensor/pytree offload tier bound to a session (deprecation-free
    internal form of ``OffloadManager`` + lifetime guard)."""

    _box_internal = True

    def __init__(self, session, paging: RemotePagingSystem,
                 config: Optional[OffloadConfig] = None) -> None:
        _Capability.__init__(self, session)
        OffloadManager.__init__(self, paging, config)

    def offload(self, name: str, array: torch.Tensor,
                wait: bool = False) -> None:
        self._guard()
        OffloadManager.offload(self, name, array, wait=wait)

    def fetch(self, name: str) -> torch.Tensor:
        self._guard()
        return OffloadManager.fetch(self, name)

    def flush(self) -> None:
        self._guard()
        OffloadManager.flush(self)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"tensors": len(self._meta),
                    "pages_allocated": self._next_page,
                    "inflight": len(self._inflight)}


class KVStore(PagedKVCache, _Capability):
    """Paged KV cache whose remote spill pages live in a dedicated arena
    reserved from the client's heap (so spills can never scribble over
    live ``RemoteBuffer`` allocations or another KVStore). ``spill``/
    ``fetch`` pick donors round-robin (or take an explicit one) and
    remember per-sequence placement."""

    _box_internal = True

    def __init__(self, session, box: RDMABox, donors: List[int],
                 num_pages: int, page_tokens: int, kv_features: int,
                 dtype=torch.float32, remote_base_page: int = 0,
                 arena_pages: Optional[int] = None) -> None:
        _Capability.__init__(self, session)
        PagedKVCache.__init__(self, num_pages, page_tokens, kv_features,
                              dtype=dtype, box=box,
                              remote_base_page=remote_base_page)
        self._donors = list(donors)
        self._rr = 0
        self._seq_donor: Dict[int, int] = {}
        self._arena_pages = arena_pages

    def add_sequence(self, seq_id: int, num_tokens: int = 0) -> None:
        self._guard()
        PagedKVCache.add_sequence(self, seq_id, num_tokens)

    def spill_sequence(self, seq_id: int, donor: int) -> None:
        # fail loudly (instead of silently walking out of the arena into
        # neighbouring heap/paging pages) when the spill bump allocator
        # would exceed the reservation
        if self._arena_pages is not None:
            needed = len(self.tables[seq_id]) * self._rdma_pages
            with self._lock:
                used = self._remote_next - self.remote_base
            if used + needed > self._arena_pages:
                raise AllocError(
                    f"KV spill arena exhausted: {used}+{needed} pages over "
                    f"the {self._arena_pages}-page reservation (spilled "
                    f"pages are not recycled; size the arena via "
                    f"kv_store(arena_pages=...))")
        PagedKVCache.spill_sequence(self, seq_id, donor)

    def spill(self, seq_id: int, donor: Optional[int] = None) -> None:
        """Evict a sequence's KV pages to remote memory (coalesced)."""
        self._guard()
        if donor is None:
            donor = self._donors[self._rr % len(self._donors)]
            self._rr += 1
        self._seq_donor[seq_id] = donor
        self.spill_sequence(seq_id, donor)

    def fetch(self, seq_id: int, donor: Optional[int] = None) -> None:
        """Bring a spilled sequence back (coalesced reads)."""
        self._guard()
        if donor is None:
            donor = self._seq_donor.get(seq_id, self._donors[0])
        self.fetch_sequence(seq_id, donor)

    def snapshot(self) -> Dict[str, object]:
        return {
            "sequences": len(self.tables),
            "spilled": len(self._spilled),
            "gather_descriptors": self.gather_descriptors,
            "gather_pages": self.gather_pages,
            "fragmentation": self.alloc.fragmentation(),
        }
