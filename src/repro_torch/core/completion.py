"""Completion queues and their event channels.

A CompletionQueue mirrors the RDMA CQ: the (simulated) NIC posts
WorkCompletions into it; consumers either poll it voluntarily or arm an
event channel and sleep until notified (ibv_req_notify_cq semantics).
"""

from __future__ import annotations

import collections
import threading
from typing import List, Optional

from .descriptors import AtomicCounter, WorkCompletion


class CompletionQueue:
    """Thread-safe CQ with optional event notification.

    The ``notify armed`` protocol follows the verbs API: events fire only
    when the consumer has re-armed notification since the last event, which
    is what makes event-triggered handling miss-free but interrupt-priced.
    """

    def __init__(self, cq_id: int = 0, capacity: int = 65536) -> None:
        self.cq_id = cq_id
        self.capacity = capacity
        self._items: collections.deque[WorkCompletion] = collections.deque()
        self._lock = threading.Lock()
        self._event = threading.Condition(self._lock)
        self._armed = False
        self._closed = False
        # stats
        self.events_fired = AtomicCounter()     # "interrupts"
        self.posted = AtomicCounter()
        self.polled = AtomicCounter()

    # ---- producer side (NIC) -------------------------------------------
    def post(self, wc: WorkCompletion) -> None:
        self.post_many([wc])

    def post_many(self, wcs: List[WorkCompletion]) -> None:
        """Batched post: the whole list appends under ONE lock acquisition
        and fires at most ONE event — the CQ side of donor-side ack
        coalescing (N jobs completed in one service round cost the
        consumer one interrupt context, not N)."""
        if not wcs:
            return
        with self._lock:
            self._items.extend(wcs)
            self.posted.add(len(wcs))
            if self._armed:
                self._armed = False
                self.events_fired.add()
                self._event.notify_all()

    # ---- consumer side --------------------------------------------------
    def poll(self, max_entries: int = 1) -> List[WorkCompletion]:
        """Non-blocking poll of up to ``max_entries`` completions."""
        out: List[WorkCompletion] = []
        with self._lock:
            while self._items and len(out) < max_entries:
                out.append(self._items.popleft())
        if out:
            self.polled.add(len(out))
        return out

    def arm(self) -> None:
        """Request an event for the next completion (req_notify_cq)."""
        with self._lock:
            self._armed = True

    def wait_event(self, timeout: Optional[float] = None) -> bool:
        """Sleep until an event fires (or work is already queued).

        Returns True on event/work, False on timeout or close. Models the
        interrupt + context switch of event-triggered mode; callers count a
        wakeup as one interrupt context.
        """
        with self._lock:
            if self._items:
                return True
            if self._closed:
                return False
            return self._event.wait(timeout=timeout)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._event.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
