"""The load-aware merge queue (§5.1, Figs. 2-3).

Every data thread enqueues its request and immediately merge-checks. The
first thread to grab the (non-blocking) merger role drains the queue and
posts; later arrivals whose requests were taken simply return. A request
that arrives alone is posted immediately as a single I/O — batching happens
*only* when the queue has stacked up under load, so light-load latency is
never sacrificed to batching.

The admission-control window gates the merger: while the window is full the
merger waits *before draining*, so blocked traffic keeps accumulating in
the queue where it gets extra chances to merge (§5.1 "Benefit").
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, List, Optional

from .admission import AdmissionController
from .descriptors import AtomicCounter, WorkRequest


class MergeQueue:
    def __init__(
        self,
        poster: Callable[[List[WorkRequest]], None],
        admission: Optional[AdmissionController] = None,
        max_drain: int = 64,
    ) -> None:
        self._queue: collections.deque[WorkRequest] = collections.deque()
        self._qlock = threading.Lock()
        self._merge_lock = threading.Lock()
        self._poster = poster
        self._admission = admission
        self.max_drain = max_drain
        # stats
        self.submitted = AtomicCounter()
        self.drains = AtomicCounter()
        self.drained_requests = AtomicCounter()
        self.solo_posts = AtomicCounter()

    def __len__(self) -> int:
        with self._qlock:
            return len(self._queue)

    def submit(self, wr: WorkRequest) -> None:
        """Enqueue + merge-check (the per-data-thread fast path)."""
        with self._qlock:
            self._queue.append(wr)
        self.submitted.add()
        self._merge_check()

    def submit_many(self, wrs: List[WorkRequest]) -> None:
        """Enqueue a whole pre-formed vector under ONE lock acquisition,
        then merge-check once — the batch-API hot path. The vector lands
        contiguously, so the merger drains it as the run it already is
        instead of re-discovering adjacency one request at a time."""
        if not wrs:
            return
        with self._qlock:
            self._queue.extend(wrs)
        self.submitted.add(len(wrs))
        self._merge_check()

    def _merge_check(self) -> None:
        # Only one merger at a time; everyone else returns immediately
        # (their request will ride in the merger's batch).
        while True:
            if not self._merge_lock.acquire(blocking=False):
                return
            try:
                if self._admission is not None:
                    # Productive waiting: requests pile up behind us.
                    self._admission.wait_for_space()
                with self._qlock:
                    n = min(len(self._queue), self.max_drain)
                    batch = [self._queue.popleft() for _ in range(n)]
                if not batch:
                    return
                self.drains.add()
                self.drained_requests.add(len(batch))
                if len(batch) == 1:
                    self.solo_posts.add()
                self._poster(batch)
            finally:
                self._merge_lock.release()
            # Close the race: items enqueued while we were posting (whose
            # submitters saw the merge lock held and returned).
            with self._qlock:
                if not self._queue:
                    return
