"""Work-Completion handling strategies (§4.2, §5.2).

All six schemes from the paper behind one interface, so they are directly
comparable (the paper's complaint is that prior work never compared them):

* BUSY         — one spinning thread per CQ; best latency, CPU burns even
                 when idle, collapses with many connections (Fig. 9b).
* EVENT        — sleep on the event channel; one wakeup ("interrupt
                 context") per WC.
* EVENT_BATCH  — per wakeup, poll up to N once; stragglers arriving just
                 after the poll wait for the next interrupt.
* SCQ(M)       — M busy pollers on M shared CQs (LITE-style); low CPU but
                 serialized completion processing.
* HYBRID_TIMER — busy-poll for a fixed timer after the last WC, then fall
                 back to event mode (X-RDMA-style).
* ADAPTIVE     — **the paper's scheme**: event-triggered; once woken,
                 batch-drain (N at a time) and keep re-polling up to
                 MAX_RETRY empty rounds before re-arming the event. Busy
                 throughput under bursts, event-level CPU when idle.

Stats per strategy: wakeups (≈ interrupt contexts), poll calls, empty
polls, handled WCs, and summed thread CPU time — the quantities behind
Figs. 5 and 9.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass
from typing import Callable, List

from .completion import CompletionQueue
from .descriptors import AtomicCounter, WCStatus, WorkCompletion

# handlers receive the whole polled batch at once, so downstream work
# (admission release, futures-table pops) amortizes its lock traffic over
# the batch instead of paying per-WC
Handler = Callable[[List[WorkCompletion]], None]


class PollMode(enum.Enum):
    BUSY = "busy"
    EVENT = "event"
    EVENT_BATCH = "event_batch"
    SCQ = "scq"
    HYBRID_TIMER = "hybrid_timer"
    ADAPTIVE = "adaptive"


@dataclass
class PollConfig:
    mode: PollMode = PollMode.ADAPTIVE
    batch: int = 16            # N: WCs fetched per poll call (batch modes)
    max_retry: int = 32        # adaptive: empty rounds before re-arming
    scq_count: int = 1         # M shared CQs (SCQ mode; set on ChannelSet)
    scq_threads_per_cq: int = 1
    hybrid_timer_us: float = 50.0


class _Stats:
    def __init__(self) -> None:
        self.wakeups = AtomicCounter()
        self.poll_calls = AtomicCounter()
        self.empty_polls = AtomicCounter()
        self.handled = AtomicCounter()
        self.errors = AtomicCounter()        # non-SUCCESS completions seen
        self._cpu_lock = threading.Lock()
        self.cpu_seconds = 0.0

    def add_cpu(self, sec: float) -> None:
        with self._cpu_lock:
            self.cpu_seconds += sec

    def snapshot(self) -> dict:
        return {
            "wakeups": self.wakeups.value,
            "poll_calls": self.poll_calls.value,
            "empty_polls": self.empty_polls.value,
            "handled": self.handled.value,
            "errors": self.errors.value,
            "cpu_seconds": self.cpu_seconds,
        }


class Poller:
    """Runs one WC-handling strategy over a set of CQs."""

    def __init__(self, cfg: PollConfig, cqs: List[CompletionQueue],
                 handler: Handler) -> None:
        self.cfg = cfg
        self.cqs = cqs
        self.handler = handler
        self.stats = _Stats()
        self._running = False
        self._threads: List[threading.Thread] = []
        self._tls = threading.local()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._running = True
        loops = {
            PollMode.BUSY: self._busy_loop,
            PollMode.EVENT: self._event_loop,
            PollMode.EVENT_BATCH: self._event_batch_loop,
            PollMode.SCQ: self._busy_loop,   # SCQ = busy pollers on shared CQs
            PollMode.HYBRID_TIMER: self._hybrid_loop,
            PollMode.ADAPTIVE: self._adaptive_loop,
        }
        loop = loops[self.cfg.mode]
        per_cq = (self.cfg.scq_threads_per_cq
                  if self.cfg.mode == PollMode.SCQ else 1)
        for cq in self.cqs:
            for _ in range(per_cq):
                t = threading.Thread(target=self._run, args=(loop, cq),
                                     daemon=True, name=f"poll-{cq.cq_id}")
                self._threads.append(t)
                t.start()

    def stop(self) -> None:
        self._running = False
        for cq in self.cqs:
            cq.close()
        for t in self._threads:
            t.join(timeout=2.0)

    def _run(self, loop, cq) -> None:
        self._tls.last = time.thread_time()
        try:
            loop(cq)
        finally:
            self._flush_cpu(0, every=1)

    def _flush_cpu(self, counter: int, every: int = 2048) -> None:
        """Periodically publish this thread's CPU time so live snapshots
        (taken while pollers still run) see it."""
        if counter % every == 0:
            now = time.thread_time()
            self.stats.add_cpu(now - self._tls.last)
            self._tls.last = now

    def _handle(self, wcs: List[WorkCompletion]) -> None:
        errors = sum(1 for wc in wcs
                     if wc.status is not WCStatus.SUCCESS)
        self.handler(wcs)            # error WCs flow through the same
        self.stats.handled.add(len(wcs))   # handler — futures surface them
        if errors:
            self.stats.errors.add(errors)

    # ---- strategies -------------------------------------------------------
    def _busy_loop(self, cq: CompletionQueue) -> None:
        s = self.stats
        n = 0
        while self._running:
            wcs = cq.poll(1)
            s.poll_calls.add()
            if wcs:
                self._handle(wcs)
            else:
                s.empty_polls.add()
            n += 1
            self._flush_cpu(n)

    def _event_loop(self, cq: CompletionQueue) -> None:
        s = self.stats
        while self._running:
            cq.arm()
            if not cq.wait_event(timeout=0.2):
                continue
            s.wakeups.add()                 # one interrupt context ...
            wcs = cq.poll(1)                # ... per WC item
            s.poll_calls.add()
            if wcs:
                self._handle(wcs)
            else:
                s.empty_polls.add()
            # flush once per wakeup (like the busy/adaptive loops), so
            # live cpu_seconds snapshots see event-mode CPU before stop()
            self._flush_cpu(0, every=1)

    def _event_batch_loop(self, cq: CompletionQueue) -> None:
        s = self.stats
        n = self.cfg.batch
        while self._running:
            cq.arm()
            if not cq.wait_event(timeout=0.2):
                continue
            s.wakeups.add()
            wcs = cq.poll(n)                # one batched poll, then back to
            s.poll_calls.add()              # event mode (stragglers wait)
            if wcs:
                self._handle(wcs)
            else:
                s.empty_polls.add()
            self._flush_cpu(0, every=1)     # flush once per wakeup

    def _hybrid_loop(self, cq: CompletionQueue) -> None:
        s = self.stats
        timer_s = self.cfg.hybrid_timer_us * 1e-6
        while self._running:
            cq.arm()
            if not cq.wait_event(timeout=0.2):
                continue
            s.wakeups.add()
            last = time.perf_counter()
            spins = 0
            while self._running and time.perf_counter() - last < timer_s:
                wcs = cq.poll(1)
                s.poll_calls.add()
                if wcs:
                    self._handle(wcs)
                    last = time.perf_counter()
                else:
                    s.empty_polls.add()
                spins += 1
                self._flush_cpu(spins)

    def _adaptive_loop(self, cq: CompletionQueue) -> None:
        """The paper's Adaptive Polling (§5.2)."""
        s = self.stats
        n = self.cfg.batch
        max_retry = self.cfg.max_retry
        while self._running:
            cq.arm()
            if not cq.wait_event(timeout=0.2):
                continue
            s.wakeups.add()
            retries = 0
            spins = 0
            while self._running and retries < max_retry:
                wcs = cq.poll(n)            # batch drain
                s.poll_calls.add()
                if wcs:
                    self._handle(wcs)
                    retries = 0             # burst: keep draining
                else:
                    s.empty_polls.add()
                    retries += 1            # dry: give it MAX_RETRY chances
                spins += 1
                self._flush_cpu(spins)
            # queue stayed dry ⇒ back to event mode (no CPU burn)
