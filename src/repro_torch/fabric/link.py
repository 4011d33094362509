"""Link model — the wire between two nodes of the fabric.

The seed engine modeled exactly one wire: the client NIC's port, a single
``Pacer`` inside ``SimulatedNIC``. That is still the right model for the
*egress* port (all traffic leaving a node serializes there, which is why
multi-QP gains are sublinear, Fig. 11), but it cannot express anything the
cluster results of §7 depend on: per-destination propagation delay, a
per-link bandwidth cap, jitter, congestion on one path, or a straggling
donor. ``Link`` carries those. A transfer now pays, in order:

1. the source node's shared egress pacer (the old "shared wire"),
2. the link's own serialization pacer when the link has a bandwidth cap,
3. propagation latency (+ jitter), which delays *delivery* of the
   completion but does not occupy either pacer — modeled by handing the
   WC to a ``DelayLine`` instead of sleeping in a NIC processing unit.

Fault multipliers (slow-donor straggler, link congestion) scale all three
components, so a degraded path holds its admission-window bytes longer —
that is the backpressure that makes a straggler delay only its own window
slots.
"""

from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..core.completion import CompletionQueue
from ..core.descriptors import PAGE_SIZE, AtomicCounter, WorkCompletion
from ..core.nic import Pacer

# below this many REAL seconds, propagation delay is folded into the
# virtual completion stamp instead of going through the DelayLine
_DELAY_EPS_REAL = 2e-4


@dataclass
class LinkConfig:
    """Per-link parameters, in virtual microseconds.

    ``gbps=None`` means the link itself is not the bottleneck (only the
    source port serializes) — the backward-compatible default.
    """

    latency_us: float = 1.0       # one-way propagation delay
    gbps: Optional[float] = None  # per-link bandwidth cap
    jitter_us: float = 0.0        # uniform extra [0, jitter_us) per transfer

    def us_per_page(self) -> Optional[float]:
        if self.gbps is None:
            return None
        return PAGE_SIZE / (self.gbps * 125.0)   # gbps → bytes per vus


class Link:
    """One directed path ``src → dst`` with its own serialization pacer."""

    def __init__(self, src: int, dst: int, cfg: LinkConfig,
                 scale: float, origin: float, seed: int = 0) -> None:
        self.src = src
        self.dst = dst
        self.cfg = cfg
        self.scale = scale
        self.pacer = Pacer(scale, origin)
        self._rng = random.Random((seed << 16) ^ (src << 8) ^ dst)
        self._rng_lock = threading.Lock()
        self.transfers = AtomicCounter()
        self.bytes = AtomicCounter()
        # zero-page transfers are control messages (donor-side acks): they
        # pay latency but not per-page serialization — counted separately
        # so per-link ack traffic is observable
        self.ctrl_transfers = AtomicCounter()

    def transmit(self, egress: Pacer, wire_us: float, num_pages: int,
                 nbytes: int, fault_mult: float = 1.0) -> Tuple[float, float]:
        """Serialize one transfer; returns (virtual completion stamp,
        residual REAL-seconds delivery delay for the DelayLine).

        ``fault_mult`` carries straggler/congestion multipliers from the
        fabric's FaultState."""
        mult = fault_mult
        end = egress.charge(wire_us * mult)
        upp = self.cfg.us_per_page()
        if upp is not None:
            end = max(end, self.pacer.charge(num_pages * upp * mult))
        lat = self.cfg.latency_us * mult
        if self.cfg.jitter_us > 0.0:
            with self._rng_lock:
                lat += self._rng.uniform(0.0, self.cfg.jitter_us) * mult
        self.transfers.add()
        self.bytes.add(nbytes)
        if num_pages == 0:
            self.ctrl_transfers.add()
        delay_real = lat * self.scale
        if delay_real < _DELAY_EPS_REAL:
            delay_real = 0.0
        return end + lat, delay_real

    def snapshot(self) -> dict:
        return {
            "src": self.src,
            "dst": self.dst,
            "transfers": self.transfers.value,
            "ctrl_transfers": self.ctrl_transfers.value,
            "bytes": self.bytes.value,
        }


class DelayLine:
    """Delivers WorkCompletions after their propagation delay.

    One timer thread per fabric; keeps NIC processing units free while a
    completion is "on the wire" (sleeping in the PU would make one slow
    destination stall unrelated transfers that share the PU).
    """

    def __init__(self) -> None:
        self._heap: List[
            Tuple[float, int, List[WorkCompletion], CompletionQueue]] = []
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._running = True

    def post_at(self, when_real: float, cq: CompletionQueue,
                wc: WorkCompletion) -> None:
        self.post_many_at(when_real, cq, [wc])

    def post_many_at(self, when_real: float, cq: CompletionQueue,
                     wcs: List[WorkCompletion]) -> None:
        """Deliver a whole coalesced-ack batch to one CQ at ``when_real``
        (one heap entry, one batched ``cq.post_many`` on expiry)."""
        with self._cv:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="fabric-delayline")
                self._thread.start()
            heapq.heappush(self._heap,
                           (when_real, next(self._seq), list(wcs), cq))
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._heap:
                    self._cv.wait(timeout=0.1)
                if not self._heap:
                    if not self._running:
                        return
                    continue
                when, _, wcs, cq = self._heap[0]
                now = time.perf_counter()
                if when > now and self._running:   # close() flushes pending
                    self._cv.wait(timeout=min(when - now, 0.05))
                    continue
                heapq.heappop(self._heap)
            now = time.perf_counter()
            for wc in wcs:
                wc.complete_rtime = now
            cq.post_many(wcs)

    def close(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
