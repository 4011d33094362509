"""Paged KV tier: page runs, the contiguity-seeking allocator, and the
paged KV cache with its remote spill tier.

``PageRun``, ``plan_page_runs`` and ``PageAllocator`` are host-side numpy
copies of ``repro/memory/kv_cache.py``'s. ``plan_page_runs`` is the
merge-queue adjacency rule at the memory tier: a sequence's page list
becomes maximal contiguous runs, so the decode kernel (and the gather,
and the remote fetch) walks one descriptor per run of pages instead of
one per page. The allocator makes runs likely by handing out the lowest
contiguous free span it can find.

``PagedKVCache`` keeps its pool as a torch tensor on the session's device
and spills sequences to donor memory through the RDMAbox engine: each
pool page goes out as a ``uint8`` view of its own bytes (no staging copy
unless a page is not a whole number of engine pages) and comes back the
same way, straight into the pool.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from .._deprecation import warn_once
from ..core.descriptors import PAGE_SIZE
from ..core.rdmabox import RDMABox


@dataclass
class PageRun:
    start: int
    length: int

    @property
    def stop(self) -> int:
        return self.start + self.length


def plan_page_runs(page_ids: Sequence[int]) -> List[PageRun]:
    """Maximal contiguous runs of a page list, preserving order."""
    runs: List[PageRun] = []
    for pid in page_ids:
        if runs and pid == runs[-1].stop:
            runs[-1].length += 1
        else:
            runs.append(PageRun(int(pid), 1))
    return runs


class PageAllocator:
    """Contiguity-seeking free-list allocator.

    ``alloc(n)`` prefers the lowest contiguous free span ≥ n; falls back to
    scattered pages when fragmented. Frees coalesce back into spans.
    """

    def __init__(self, num_pages: int) -> None:
        self.num_pages = num_pages
        self._free = np.ones(num_pages, dtype=bool)
        self.free_count = num_pages

    def alloc(self, n: int = 1) -> List[int]:
        if n > self.free_count:
            raise MemoryError(f"KV pool exhausted: want {n}, free {self.free_count}")
        free_idx = np.flatnonzero(self._free)
        out: List[int] = []
        breaks = np.where(np.diff(free_idx) != 1)[0]
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [len(free_idx) - 1]])
        for s, e in zip(starts, ends):
            if e - s + 1 >= n:
                out = free_idx[s : s + n].tolist()
                break
        if not out:  # fragmented: take lowest n free pages
            out = free_idx[:n].tolist()
        self._free[out] = False
        self.free_count -= n
        return out

    def free(self, pages: Sequence[int]) -> None:
        pages = list(pages)
        if self._free[pages].any():
            raise ValueError(f"double free in {pages}")
        self._free[pages] = True
        self.free_count += len(pages)

    def fragmentation(self) -> float:
        """1 − (largest free span / total free)."""
        free_idx = np.flatnonzero(self._free)
        if len(free_idx) == 0:
            return 0.0
        spans = np.split(free_idx, np.where(np.diff(free_idx) != 1)[0] + 1)
        return 1.0 - max(len(s) for s in spans) / len(free_idx)


class PagedKVCache:
    """Paged KV pool on a device, with an optional remote spill tier."""

    def __init__(self, num_pages: int, page_tokens: int, kv_features: int,
                 dtype: torch.dtype = torch.float32,
                 box: Optional[RDMABox] = None,
                 remote_base_page: int = 0,
                 device: Union[None, str, torch.device] = None) -> None:
        """The pool lives on ``box.device`` when a box is attached (the
        session's device), else on ``device`` (default ``"cuda"``)."""
        if not getattr(self, "_box_internal", False):
            warn_once(
                "PagedKVCache",
                "constructing PagedKVCache directly is deprecated; use "
                "repro_torch.box.open(spec).kv_store(...)")
        if device is None:
            device = box.device if box is not None else "cuda"
        self.page_tokens = page_tokens
        self.kv_features = kv_features
        self.dtype = dtype
        self.pool = torch.zeros((num_pages, page_tokens, kv_features),
                                dtype=dtype, device=resolve_device(device))
        self.alloc = PageAllocator(num_pages)
        self.tables: Dict[int, List[int]] = {}      # seq id → page list
        self.lengths: Dict[int, int] = {}           # seq id → tokens used
        self.box = box
        self.remote_base = remote_base_page
        self._page_bytes = page_tokens * kv_features * dtype.itemsize
        self._rdma_pages = max(1, -(-self._page_bytes // PAGE_SIZE))
        # a pool page is sent as a view of its own bytes unless it is not
        # a whole number of engine pages: then through a padded copy
        self._pad = self._rdma_pages * PAGE_SIZE - self._page_bytes
        self._spilled: Dict[Tuple[int, int], int] = {}  # (seq, pos) → remote page
        self._remote_next = remote_base_page                # bump allocator
        self._remote_free: List[int] = []
        self._lock = threading.Lock()   # guards alloc/tables/remote maps
        # stats
        self.gather_descriptors = 0
        self.gather_pages = 0

    # ---- sequence lifecycle -------------------------------------------------
    def add_sequence(self, seq_id: int, num_tokens: int = 0) -> None:
        if seq_id in self.tables:
            raise ValueError(f"sequence {seq_id} already present")
        n = -(-num_tokens // self.page_tokens) if num_tokens else 0
        with self._lock:
            self.tables[seq_id] = self.alloc.alloc(n) if n else []
        self.lengths[seq_id] = num_tokens

    def append_tokens(self, seq_id: int, kv: torch.Tensor) -> None:
        """kv: (T, kv_features) new tokens for the sequence (converted to
        the pool's dtype and device); one slice write per page touched."""
        kv = torch.as_tensor(kv).to(device=self.pool.device, dtype=self.dtype)
        t = self.lengths[seq_id]
        need = -(-(t + len(kv)) // self.page_tokens) - len(self.tables[seq_id])
        if need > 0:
            with self._lock:
                self.tables[seq_id].extend(self.alloc.alloc(need))
        i = 0
        while i < len(kv):
            page = self.tables[seq_id][t // self.page_tokens]
            off = t % self.page_tokens
            k = min(self.page_tokens - off, len(kv) - i)
            self.pool[page, off : off + k] = kv[i : i + k]
            i += k
            t += k
        self.lengths[seq_id] = t

    def free_sequence(self, seq_id: int) -> None:
        self.alloc.free(self.tables.pop(seq_id))
        self.lengths.pop(seq_id)

    # ---- coalesced gather (the paper's technique, local form) ---------------
    def gather(self, seq_id: int) -> torch.Tensor:
        """Materialize a sequence's KV as (tokens, kv_features).

        One slice per contiguous *run*, not per page — load-aware batching
        applied to the gather. Stats record the descriptor reduction.
        """
        pages = self.tables[seq_id]
        runs = plan_page_runs(pages)
        self.gather_descriptors += len(runs)
        self.gather_pages += len(pages)
        parts = [self.pool[r.start : r.stop].reshape(-1, self.kv_features)
                 for r in runs]
        out = torch.cat(parts) if parts else self.pool.new_zeros(
            (0, self.kv_features))
        return out[: self.lengths[seq_id]]

    # ---- remote spill tier ---------------------------------------------------
    def _page_bytes_view(self, page: int) -> torch.Tensor:
        """A pool page's bytes as a flat ``uint8`` view (aliases the pool)."""
        return self.pool[page].reshape(-1).view(torch.uint8)

    def spill_sequence(self, seq_id: int, donor: int) -> None:
        """Evict a sequence's pages to the remote pool (coalesced writes)."""
        if self.box is None:
            raise RuntimeError("no RDMA box attached")
        pages = self.tables[seq_id]
        # reserve ONE contiguous remote range per sequence: sequential spill
        # writes stay adjacent ⇒ the merge queue coalesces them (and the
        # fetch path reads back whole runs). Interleaving a shared bump
        # pointer across threads would destroy exactly the adjacency the
        # engine exploits.
        with self._lock:
            base_remote = self._remote_next
            self._remote_next += len(pages) * self._rdma_pages
        pairs = []
        for pos, page in enumerate(pages):
            remote = base_remote + pos * self._rdma_pages
            data = self._page_bytes_view(page)
            if self._pad:                               # pad to page multiple
                data = torch.cat([data, data.new_zeros(self._pad)])
            pairs.append((remote, data))
            self._spilled[(seq_id, pos)] = remote
        # the sequence's whole range rides the batch API: one submit-lock
        # acquisition, one future for the spill instead of one per page.
        # The engine orders its copies after the work queued on the pool
        # (a kernel that just wrote these pages), and the wait returns once
        # the bytes have landed, so the pages are free to reuse after it.
        self.box.write_pages(donor, pairs).wait()
        with self._lock:
            self.alloc.free(pages)
        self.tables[seq_id] = [-1] * len(pages)   # -1 = remote

    def fetch_sequence(self, seq_id: int, donor: int) -> None:
        """Bring a spilled sequence back (coalesced reads, straight into
        the pool's pages unless a page needs padding)."""
        if self.box is None:
            raise RuntimeError("no RDMA box attached")
        n = len(self.tables[seq_id])
        with self._lock:
            local = self.alloc.alloc(n)
        pairs, bufs = [], []
        for pos, page in enumerate(local):
            with self._lock:
                remote = self._spilled.pop((seq_id, pos))
                self._remote_free.append(remote)
            if self._pad:
                buf = self.pool.new_empty(self._rdma_pages * PAGE_SIZE,
                                          dtype=torch.uint8)
                bufs.append((page, buf))
            else:
                buf = self._page_bytes_view(page)
            pairs.append((remote, buf))
        # one batched read for the sequence: donor-side copies land
        # straight in the pool pages, one event for the whole fetch
        self.box.read_pages(donor, pairs).wait()
        for page, buf in bufs:
            self._page_bytes_view(page).copy_(buf[: self._page_bytes])
        self.tables[seq_id] = local
