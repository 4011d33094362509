"""Paged KV tier, host side: page runs and the contiguity-seeking allocator.

A copy of ``repro/memory/kv_cache.py``'s ``PageRun``, ``plan_page_runs``
and ``PageAllocator`` (plain numpy, no device state). ``plan_page_runs``
is the merge-queue adjacency rule at the memory tier: a sequence's page
list becomes maximal contiguous runs, so the decode kernel walks one
descriptor per run of pages instead of one per page. The allocator makes
runs likely by handing out the lowest contiguous free span it can find.

The reference's ``PagedKVCache`` and its remote spill ride the RDMAbox
engine, which the port has not yet; they land with it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


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
