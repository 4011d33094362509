"""Service centers — the analytic mirror of the simulator's pacers.

The threaded engine charges every request's costs to a small set of
``Pacer`` resources: the client's PUs and egress wire, the per-path
link, the donor's ingress PUs (one per service worker), the donor's
shared wire (region bandwidth + ack leg), and — for write-through
configs — the disk tier. A ``Center`` is the closed-form counterpart of
one such resource: it accumulates per-class offered load (arrival rate
x mean service time) and produces a ``<latency, bandwidth, load>``
estimate instead of sleeping threads.

Queueing model: each center is an M/G/k station solved with the
Erlang-C delay probability scaled by the Allen–Cunneen variability
correction ``(ca2 + cs2) / 2`` — Poisson-ish arrivals (``ca2 = 1``)
over deterministic simulated service costs (``cs2 = 0``) reduce to the
classic M/D/k half-of-M/M/k wait. A center whose utilization reaches
the saturation threshold reports ``saturated=True`` (the analytic
analogue of the simulator's admission-window shrink) and clamps its
queue-delay estimate at the threshold instead of diverging, so a sweep
over an overloaded grid still returns finite, rankable numbers.

``CenterLink`` is the one center that also carries a pure *delay*
(propagation latency): delay contributes to response time but never to
utilization — exactly how the simulator's ``DelayLine`` delivers
completions without occupying a pacer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

# utilization at which a center is reported saturated; matches the point
# where the simulated engine's queues grow faster than the admission
# hook can drain them
SATURATION_RHO = 0.95


def erlang_c(servers: int, offered: float) -> float:
    """P(wait) for an M/M/k with ``offered = lambda * D`` Erlangs.

    Stable only for ``offered < servers``; callers clamp first. Computed
    with the usual iterative term accumulation (no factorial overflow).
    """
    if offered <= 0.0:
        return 0.0
    rho = offered / servers
    term = 1.0          # a^0 / 0!
    acc = term
    for n in range(1, servers):
        term *= offered / n
        acc += term
    last = term * (offered / servers) / (1.0 - rho)
    return last / (acc + last)


@dataclass
class CenterEstimate:
    """One center's ``<latency, bandwidth, load>`` card."""

    name: str
    kind: str
    servers: int
    count: int                  # identical physical instances (symmetry)
    service_us: float           # mean per-visit service time
    utilization: float          # rho, per instance
    queue_us: float             # mean wait before service (clamped)
    delay_us: float             # pure propagation delay (links only)
    capacity_ops_per_s: float   # visits/s one instance can absorb
    throughput_ops_per_s: float  # offered visits/s, per instance
    saturated: bool

    def snapshot(self) -> Dict[str, object]:
        return {
            "kind": self.kind,
            "servers": self.servers,
            "count": self.count,
            "service_us": self.service_us,
            "utilization": self.utilization,
            "queue_us": self.queue_us,
            "delay_us": self.delay_us,
            "capacity_ops_per_s": self.capacity_ops_per_s,
            "throughput_ops_per_s": self.throughput_ops_per_s,
            "saturated": self.saturated,
        }


@dataclass
class Center:
    """One shared resource: per-class demands in, queue-delay out.

    ``add_visits(cls, rate, service_us)`` accumulates a request class's
    offered load — ``rate`` visits per virtual microsecond (per
    *instance* of this center), each holding the server ``service_us``.
    ``solve()`` freezes the totals into a ``CenterEstimate``;
    ``wait_us(cls)`` then reads the (possibly class-weighted) queue
    delay for one class.
    """

    name: str
    kind: str = "pu"
    servers: int = 1
    count: int = 1
    delay_us: float = 0.0       # propagation; CenterLink only
    arrival_cv2: float = 1.0
    service_cv2: float = 0.0
    saturation_rho: float = SATURATION_RHO
    # class name -> [rate_per_us, demand_us_per_us]
    _loads: Dict[str, list] = field(default_factory=dict)
    # class name -> queue-share weight (SLO DRR weights; default 1.0)
    _weights: Dict[str, float] = field(default_factory=dict)

    def add_visits(self, cls: str, rate_per_us: float,
                   service_us: float, weight: float = 1.0) -> None:
        if rate_per_us <= 0.0 or service_us < 0.0:
            return
        load = self._loads.setdefault(cls, [0.0, 0.0])
        load[0] += rate_per_us
        load[1] += rate_per_us * service_us
        self._weights[cls] = weight

    # ---- solving -----------------------------------------------------------
    def solve(self) -> CenterEstimate:
        rate = sum(v[0] for v in self._loads.values())
        demand = sum(v[1] for v in self._loads.values())
        service = demand / rate if rate > 0.0 else 0.0
        rho = demand / self.servers
        saturated = rho >= self.saturation_rho
        # clamp at the threshold so overloaded grids stay finite/rankable
        eff_rho = min(rho, self.saturation_rho)
        offered = eff_rho * self.servers
        if rate > 0.0 and service > 0.0:
            pw = erlang_c(self.servers, offered)
            vari = (self.arrival_cv2 + self.service_cv2) / 2.0
            queue = pw * vari * service / (self.servers * (1.0 - eff_rho))
        else:
            queue = 0.0
        capacity = (self.servers / service * 1e6) if service > 0.0 else 0.0
        self._estimate = CenterEstimate(
            name=self.name, kind=self.kind, servers=self.servers,
            count=self.count, service_us=service, utilization=rho,
            queue_us=queue, delay_us=self.delay_us,
            capacity_ops_per_s=capacity,
            throughput_ops_per_s=rate * 1e6, saturated=saturated)
        return self._estimate

    def wait_us(self, cls: str) -> float:
        """Mean queue delay seen by ``cls`` at this center.

        With uniform weights this is the FIFO wait for everyone. With
        SLO DRR weights the total wait is redistributed inversely to
        class weight under a conservation constraint (the weighted
        dispatcher serves heavy classes first, it does not create or
        destroy waiting time): ``W_s = W * K / w_s`` with ``K`` chosen
        so ``sum(rate_s * W_s) == sum(rate_s) * W``.
        """
        est = getattr(self, "_estimate", None) or self.solve()
        base = est.queue_us
        if base <= 0.0 or not self._loads:
            return 0.0
        weights = set(self._weights.values())
        if len(weights) <= 1:
            return base
        total_rate = sum(v[0] for v in self._loads.values())
        denom = sum(v[0] / self._weights[c]
                    for c, v in self._loads.items())
        if denom <= 0.0:
            return base
        k = total_rate / denom
        return base * k / self._weights.get(cls, 1.0)

    # p-th quantile of the wait, assuming the waiting time past the mean
    # decays exponentially (exact for M/M/1, conservative for M/D/k)
    def wait_quantile_us(self, cls: str, q: float) -> float:
        w = self.wait_us(cls)
        if w <= 0.0:
            return 0.0
        return w * math.log(1.0 / (1.0 - q))


def make_center(kind: str, name: str, **kwargs) -> Center:
    """Factory keyed by the resource kinds the engine composes."""
    cls = CENTER_KINDS[kind]
    return cls(name=name, **kwargs)


@dataclass
class CenterPU(Center):
    """A NIC processing-unit pool (client PUs or donor ingress workers):
    ``servers`` parallel units fed from one queue — the analytic form of
    ``serve_workers`` pinned to PU pacers."""

    kind: str = "pu"


@dataclass
class CenterWire(Center):
    """A node's shared egress port: everything leaving the node
    serializes here (why multi-QP gains are sublinear, Fig. 11)."""

    kind: str = "wire"
    servers: int = 1


@dataclass
class CenterLink(Center):
    """A directed fabric path: optional per-link bandwidth pacer plus a
    pure propagation delay that never occupies the server."""

    kind: str = "link"
    servers: int = 1


@dataclass
class CenterRegionBW(Center):
    """The donor region's memory bandwidth (the donor NIC's shared wire
    pacer in the simulator) — cache-hit pages never visit it."""

    kind: str = "region-bw"
    servers: int = 1


@dataclass
class CenterDisk(Center):
    """The write-through disk tier; only loaded when the spec persists
    writes to disk."""

    kind: str = "disk"
    servers: int = 1


CENTER_KINDS = {
    "pu": CenterPU,
    "wire": CenterWire,
    "link": CenterLink,
    "region-bw": CenterRegionBW,
    "disk": CenterDisk,
}
