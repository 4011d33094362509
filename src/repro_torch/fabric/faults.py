"""Fault injection — scripted and probabilistic degradation of the fabric.

The paper's replication design exists *because* donors fail and straggle
("disk access occurs only when all replication is failed", §6). A
``FaultPlan`` is the declarative script of what goes wrong during a run:

    plan = (FaultPlan(seed=7)
            .crash(node=2, after_ops=100)      # donor 2 dies mid-run
            .slow(node=3, factor=25.0)         # donor 3 straggles from t=0
            .flaky(node=1, prob=0.05, max_errors=8)   # transient WC errors
            .congest(src=0, dst=1, factor=4.0))       # one hot path

``FaultState`` is the compiled runtime: the NIC consults it once per
transfer descriptor (``transfer_status`` — returns a non-SUCCESS WCStatus
to inject, or None) and once for pacing (``wire_multiplier``). Triggers
count *ops seen toward a node* or virtual time, so scripted faults are
deterministic under fixed workloads; probabilistic faults draw from one
seeded RNG. Crash/recover can also be driven imperatively mid-run
(``Fabric.crash``/``Fabric.recover``) for test choreography.
"""

from __future__ import annotations

import dataclasses
import enum
import random
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..core.descriptors import AtomicCounter, WCStatus


class FaultKind(enum.Enum):
    CRASH = "crash"       # node becomes unreachable: RETRY_EXC_ERR forever
    SLOW = "slow"         # straggler: latency/serialization multiplier
    FLAKY = "flaky"       # per-transfer transient errors with probability p
    CONGEST = "congest"   # one directed link gets a bandwidth/latency multiplier


@dataclass
class FaultEvent:
    kind: FaultKind
    node: Optional[int] = None            # crash/slow/flaky target
    src: Optional[int] = None             # congest: directed link endpoints
    dst: Optional[int] = None
    after_ops: int = 0                    # trigger after N ops toward node
    at_us: Optional[float] = None         # or at virtual time (whichever first)
    factor: float = 1.0                   # slow/congest multiplier
    prob: float = 0.0                     # flaky probability per transfer
    status: WCStatus = WCStatus.RNR_RETRY_ERR
    max_errors: Optional[int] = None      # flaky: cap injected errors
    until_us: Optional[float] = None      # congest: episode end (virtual time)


class FaultPlan:
    """Chainable builder for a list of FaultEvents."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.events: List[FaultEvent] = []

    def crash(self, node: int, after_ops: int = 0,
              at_us: Optional[float] = None) -> "FaultPlan":
        self.events.append(FaultEvent(FaultKind.CRASH, node=node,
                                      after_ops=after_ops, at_us=at_us))
        return self

    def slow(self, node: int, factor: float, after_ops: int = 0,
             at_us: Optional[float] = None) -> "FaultPlan":
        self.events.append(FaultEvent(FaultKind.SLOW, node=node,
                                      factor=factor, after_ops=after_ops,
                                      at_us=at_us))
        return self

    def flaky(self, node: int, prob: float,
              status: WCStatus = WCStatus.RNR_RETRY_ERR,
              max_errors: Optional[int] = None,
              after_ops: int = 0) -> "FaultPlan":
        self.events.append(FaultEvent(FaultKind.FLAKY, node=node, prob=prob,
                                      status=status, max_errors=max_errors,
                                      after_ops=after_ops))
        return self

    def congest(self, src: int, dst: int, factor: float,
                after_ops: int = 0,
                until_us: Optional[float] = None) -> "FaultPlan":
        """Congest one directed link; ``until_us`` bounds the episode — the
        multiplier lifts once virtual time passes it (congestion-aware
        admission should then re-expand its window)."""
        self.events.append(FaultEvent(FaultKind.CONGEST, src=src, dst=dst,
                                      factor=factor, after_ops=after_ops,
                                      until_us=until_us))
        return self


class FaultState:
    """Runtime fault machine consulted by every NIC in the fabric."""

    def __init__(self, plan: Optional[FaultPlan],
                 now_us: Callable[[], float]) -> None:
        self._plan = plan or FaultPlan()
        self._now_us = now_us
        self._rng = random.Random(self._plan.seed)
        self._lock = threading.Lock()
        self._ops: Dict[int, int] = {}            # transfers seen toward node
        self._crashed: set[int] = set()
        self._slow: Dict[int, float] = {}
        self._congest: Dict[Tuple[int, int], float] = {}
        self._congest_until: Dict[Tuple[int, int], Optional[float]] = {}
        self._flaky_budget: Dict[int, Optional[int]] = {}
        # private copies: arming mutates events, and one FaultPlan may be
        # reused to build several fabrics (e.g. re-run bench scenarios)
        self._pending = [dataclasses.replace(ev) for ev in self._plan.events]
        self.injected = AtomicCounter()           # non-SUCCESS statuses issued
        # events with no trigger condition are live immediately
        self._arm()

    # ---- trigger machinery -------------------------------------------------
    def _arm(self) -> None:
        """Activate pending events whose trigger has fired (lock held or init)."""
        now = self._now_us()
        still: List[FaultEvent] = []
        for ev in self._pending:
            if ev.kind is FaultKind.FLAKY and ev.after_ops == -1:
                still.append(ev)            # already armed, stays live
                continue
            node = ev.node if ev.node is not None else ev.dst
            # "whichever first": the time trigger when set, the ops trigger
            # when set (an explicit after_ops; the default 0 only counts as
            # a trigger when no at_us was given, else it would always fire)
            fired = ev.at_us is not None and now >= ev.at_us
            if (ev.at_us is None or ev.after_ops > 0) and \
                    self._ops.get(node, 0) >= ev.after_ops:
                fired = True
            if not fired:
                still.append(ev)
                continue
            if ev.kind == FaultKind.CRASH:
                self._crashed.add(ev.node)
            elif ev.kind == FaultKind.SLOW:
                self._slow[ev.node] = ev.factor
            elif ev.kind == FaultKind.CONGEST:
                self._congest[(ev.src, ev.dst)] = ev.factor
                self._congest_until[(ev.src, ev.dst)] = ev.until_us
            elif ev.kind == FaultKind.FLAKY:
                self._flaky_budget[ev.node] = ev.max_errors
                still.append(ev)            # flaky stays live once armed
                ev.after_ops = -1           # mark as armed (always fires)
        self._pending = still

    # ---- NIC-facing queries ------------------------------------------------
    def transfer_status(self, src: int, dst: int) -> Optional[WCStatus]:
        """Called once per descriptor headed ``src → dst``; returns the
        WCStatus to inject (≠ SUCCESS) or None for a healthy transfer."""
        with self._lock:
            self._ops[dst] = self._ops.get(dst, 0) + 1
            self._arm()
            if dst in self._crashed:
                self.injected.add()
                return WCStatus.RETRY_EXC_ERR
            for ev in self._pending:
                if ev.kind is not FaultKind.FLAKY or ev.node != dst:
                    continue
                if ev.after_ops != -1:      # not yet armed
                    continue
                budget = self._flaky_budget.get(dst)
                if budget is not None and budget <= 0:
                    continue
                if self._rng.random() < ev.prob:
                    if budget is not None:
                        self._flaky_budget[dst] = budget - 1
                    self.injected.add()
                    return ev.status
        return None

    def _congest_factor(self, key: Tuple[int, int]) -> float:
        """Congestion multiplier for one directed pair, expiring bounded
        episodes (lock held)."""
        until = self._congest_until.get(key)
        if until is not None and self._now_us() >= until:
            self._congest.pop(key, None)
            self._congest_until.pop(key, None)
            return 1.0
        return self._congest.get(key, 1.0)

    def wire_multiplier(self, src: int, dst: int) -> float:
        with self._lock:
            self._arm()
            return self._slow.get(dst, 1.0) * self._congest_factor((src, dst))

    def serve_multiplier(self, donor: int, client: int) -> float:
        """Multiplier for the donor-side leg of a transfer: the donor's own
        slowness (a straggler serves and acks slowly) times congestion on
        the reverse ``donor → client`` path the ack travels."""
        with self._lock:
            self._arm()
            return (self._slow.get(donor, 1.0)
                    * self._congest_factor((donor, client)))

    # ---- imperative control (test choreography) ----------------------------
    def crash_node(self, node: int) -> None:
        with self._lock:
            self._crashed.add(node)

    def recover_node(self, node: int) -> None:
        with self._lock:
            self._crashed.discard(node)
            self._slow.pop(node, None)

    def congest_link(self, src: int, dst: int, factor: float,
                     until_us: Optional[float] = None) -> None:
        """Imperative congestion episode on one directed link."""
        with self._lock:
            self._congest[(src, dst)] = factor
            self._congest_until[(src, dst)] = until_us

    def clear_congestion(self, src: int, dst: int) -> None:
        with self._lock:
            self._congest.pop((src, dst), None)
            self._congest_until.pop((src, dst), None)

    def is_crashed(self, node: int) -> bool:
        with self._lock:
            return node in self._crashed

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "crashed": sorted(self._crashed),
                "slow": dict(self._slow),
                "congested": {f"{s}->{d}": f for (s, d), f in
                              self._congest.items()},
                "injected": self.injected.value,
            }
