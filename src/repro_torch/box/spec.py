"""Declarative cluster description — the input to ``repro_torch.box.open``.

A ``ClusterSpec`` is plain data: topology (donors, clients), durability
(replication, disk), the link model, a fault script, policy names with
parameters, and the engine knobs. It round-trips through ``dict``/JSON so
a deployment is a config file, not wiring code:

    spec = ClusterSpec(num_donors=3, replication=2, heap_pages=1024,
                       admission="congestion",
                       faults=[{"kind": "slow", "node": 2, "factor": 25.0}])
    session = repro_torch.box.open(spec)

Policies are referenced by registry name (see ``repro_torch.box.policies``)
with an optional parameter dict; objects that cannot be serialized
(a pre-built ``BoxConfig``, an imperative ``FaultPlan``, a shared
``DiskTier``) are *not* spec fields — they are escape-hatch keyword
arguments of ``Session``/``open`` for legacy and advanced callers.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from ..core.descriptors import WCStatus
from ..fabric.faults import FaultPlan
from ..fabric.link import LinkConfig

# execution backends ``box.open`` can dispatch a spec to
VALID_BACKENDS = ("sim", "model")


@dataclass
class PolicySpec:
    """A registry reference: policy name + constructor parameters."""

    name: str
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def coerce(cls, value: Union[str, Dict[str, Any], "PolicySpec"]
               ) -> "PolicySpec":
        if isinstance(value, PolicySpec):
            return value
        if isinstance(value, str):
            return cls(name=value)
        if isinstance(value, dict):
            return cls(name=value["name"], params=dict(value.get("params", {})))
        raise TypeError(f"policy reference must be str/dict/PolicySpec, "
                        f"got {type(value).__name__}")

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "params": dict(self.params)}


@dataclass(frozen=True)
class SLAClass:
    """A tenant service level: dispatch weight, backlog priority, and an
    optional tail-latency contract.

    Instances are compiled from class *names* on ``ClusterSpec.sla`` via
    the ``sla`` policy registry (built-ins: ``premium``, ``standard``,
    ``best_effort``) plus per-spec overrides in ``ClusterSpec.sla_classes``
    — only names and parameter dicts cross the JSON boundary.

    Args:
        name: the class name clients reference from ``ClusterSpec.sla``.
        weight: DRR quantum multiplier on the donor dispatcher — a
            weight-2 class accrues twice the per-round byte credit.
        priority: backlog tie-break; higher-priority queues are visited
            first under contention, so they are skipped *last*.
        p99_target_us: optional tail-latency contract (virtual
            microseconds). Drives deadline ordering on the donor and the
            ``protected`` admission guard; ``None`` = best effort.
        protected: when True, SLO-aware admission keeps this client's
            window at full size under fabric ECN marks unless its OWN
            observed p99 exceeds ``p99_target_us``.
        ecn_mark_fraction: the fraction of a window-adjust interval's
            completions that must carry ECN marks before admission calls
            the path congested — lower = shrink earlier.

    Raises:
        ValueError: from ``validate`` on a non-positive weight or target,
            or an ``ecn_mark_fraction`` outside ``(0, 1]``.
    """

    name: str
    weight: float = 1.0
    priority: int = 0
    p99_target_us: Optional[float] = None
    protected: bool = False
    ecn_mark_fraction: float = 0.5

    def validate(self) -> "SLAClass":
        if not self.name:
            raise ValueError("SLA class name must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"SLA class {self.name!r}: weight must be > 0")
        if self.p99_target_us is not None and self.p99_target_us <= 0:
            raise ValueError(f"SLA class {self.name!r}: p99_target_us "
                             f"must be > 0 (or None)")
        if not 0.0 < self.ecn_mark_fraction <= 1.0:
            raise ValueError(f"SLA class {self.name!r}: ecn_mark_fraction "
                             f"must be in (0, 1]")
        return self


# fault-event fields that serialize verbatim (status is special-cased:
# it crosses the JSON boundary as the WCStatus member name)
_FAULT_FIELDS = ("kind", "node", "src", "dst", "after_ops", "at_us",
                 "factor", "prob", "max_errors", "until_us")


def fault_plan_from_dicts(events: List[Dict[str, Any]],
                          seed: int = 0) -> FaultPlan:
    """Compile declarative fault-event dicts into a ``FaultPlan``."""
    plan = FaultPlan(seed=seed)
    for ev in events:
        kind = ev["kind"]
        if kind == "crash":
            plan.crash(node=ev["node"], after_ops=ev.get("after_ops", 0),
                       at_us=ev.get("at_us"))
        elif kind == "slow":
            plan.slow(node=ev["node"], factor=ev["factor"],
                      after_ops=ev.get("after_ops", 0),
                      at_us=ev.get("at_us"))
        elif kind == "flaky":
            status = ev.get("status", WCStatus.RNR_RETRY_ERR.name)
            plan.flaky(node=ev["node"], prob=ev["prob"],
                       status=WCStatus[status] if isinstance(status, str)
                       else status,
                       max_errors=ev.get("max_errors"),
                       after_ops=ev.get("after_ops", 0))
        elif kind == "congest":
            plan.congest(src=ev["src"], dst=ev["dst"], factor=ev["factor"],
                         after_ops=ev.get("after_ops", 0),
                         until_us=ev.get("until_us"))
        else:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(crash/slow/flaky/congest)")
    return plan


def fault_plan_to_dicts(plan: FaultPlan) -> List[Dict[str, Any]]:
    """The inverse of ``fault_plan_from_dicts`` (drops default fields)."""
    out = []
    for ev in plan.events:
        d: Dict[str, Any] = {"kind": ev.kind.value}
        for name in _FAULT_FIELDS[1:]:
            val = getattr(ev, name)
            if val not in (None, 0, 0.0) or (name == "factor" and
                                             ev.kind.value in ("slow",
                                                               "congest")):
                d[name] = val
        if ev.kind.value == "flaky":
            d["status"] = ev.status.name
        out.append(d)
    return out


@dataclass
class ClusterSpec:
    """Everything ``repro_torch.box.open`` needs to build a Session, as data.

    Donor-region layout: each donor's region of ``donor_pages`` is split
    into one slice per client; within a client's slice the first
    ``share - heap_pages`` pages back the ``Pager`` and the last
    ``heap_pages`` back the ``RemoteHeap`` (and the ``KVStore`` spill
    arena). ``heap_pages=0`` reproduces the pre-``repro_torch.box`` layout
    exactly (whole slice to paging, heap allocation disabled).
    """

    # topology
    num_donors: int = 3
    donor_pages: int = 16384
    num_clients: int = 1
    client_node: int = 0
    donor_nics: bool = True     # False: bare regions, client-side completion
    # durability / paging
    replication: int = 2
    stripe_pages: int = 16
    heap_pages: int = 0
    write_through_disk: bool = False
    first_responder: bool = False
    evict_after: int = 3
    disk_latency_us: float = 100.0
    # engine knobs (BoxConfig equivalents)
    channels_per_peer: int = 4
    window_bytes: Optional[int] = 8 << 20
    max_drain: int = 64
    kernel_space: bool = True
    reg_mode: str = "auto"
    nic_scale: float = 1e-6
    rnr_retry_limit: int = 3
    rnr_backoff_us: float = 200.0
    nic_cost: Optional[Dict[str, float]] = None   # NICCostModel overrides
    # donor-side service workers per NIC (None → one per modeled PU);
    # finer service-plane knobs (DRR quantum, merging, ack coalescing)
    # live on the ``service`` policy below
    serve_workers: Optional[int] = None
    # donor-side hot-page cache capacity (None → the ``cache`` policy's
    # own capacity, which defaults to 0 = disabled); finer knobs
    # (promotion threshold) live on the ``cache`` policy below
    donor_cache_pages: Optional[int] = None
    # donor-side MR-cache capacity: at most N donor pages are registered
    # at once, the rest register lazily on first touch (fault → register
    # → RNR replay) and deregister on LRU eviction. None → the ``mr``
    # policy's own capacity, which defaults to 0 = disabled (every page
    # pre-registered, the historical behavior, bit for bit)
    registered_pages: Optional[int] = None
    # predictive MR prefetch overrides on the ``mr`` policy: a dict with
    # any of ``depth`` (lookahead in strides; 0 disables prediction),
    # ``degree`` (predicted extents per trigger), ``confidence``
    # (repeated strides before predicting). None → the policy's own
    # knobs, which default to prediction off (the plain MR cache, bit for bit)
    mr_prefetch: Optional[Dict[str, int]] = None
    # decorrelated jitter on the client RNR replay backoff (see
    # BoxConfig.rnr_jitter_seed); None keeps deterministic doubling
    rnr_jitter_seed: Optional[int] = None
    # per-client SLA class names — a single name applies to every client,
    # a list gives one class per client (len == num_clients). Names
    # resolve through the ``sla`` policy registry (premium / standard /
    # best_effort built in) with optional per-spec parameter overrides or
    # brand-new classes in ``sla_classes``. None = every client equal
    # (the pre-SLO behavior, bit for bit).
    sla: Optional[Union[str, List[str]]] = None
    sla_classes: Optional[Dict[str, Dict[str, Any]]] = None
    # link model ({"latency_us": .., "gbps": .., "jitter_us": ..})
    link: Optional[Dict[str, Any]] = None
    # fault script (list of event dicts, see fault_plan_from_dicts)
    faults: Optional[List[Dict[str, Any]]] = None
    seed: int = 0
    # execution backend: "sim" = the thread-per-NIC simulator (default),
    # "model" = the closed-form queueing-model evaluator (not ported yet)
    backend: str = "sim"
    # policies, by registry name
    admission: PolicySpec = field(
        default_factory=lambda: PolicySpec("static"))
    polling: PolicySpec = field(
        default_factory=lambda: PolicySpec("adaptive"))
    batching: PolicySpec = field(
        default_factory=lambda: PolicySpec("hybrid"))
    placement: PolicySpec = field(
        default_factory=lambda: PolicySpec("striped"))
    service: PolicySpec = field(
        default_factory=lambda: PolicySpec("drr"))
    cache: PolicySpec = field(
        default_factory=lambda: PolicySpec("freq-clock"))
    mr: PolicySpec = field(
        default_factory=lambda: PolicySpec("lru"))

    _POLICY_FIELDS = ("admission", "polling", "batching", "placement",
                      "service", "cache", "mr")

    def __post_init__(self) -> None:
        for name in self._POLICY_FIELDS:
            setattr(self, name, PolicySpec.coerce(getattr(self, name)))

    # ---- validation --------------------------------------------------------
    def validate(self) -> "ClusterSpec":
        if self.backend not in VALID_BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}: valid backends are "
                f"{', '.join(repr(b) for b in VALID_BACKENDS)}")
        if self.num_donors < 1:
            raise ValueError("num_donors must be >= 1")
        if self.num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        if self.replication < 1:
            raise ValueError("replication must be >= 1")
        if self.serve_workers is not None and self.serve_workers < 1:
            raise ValueError("serve_workers must be >= 1 (or None for "
                             "one worker per modeled PU)")
        if self.donor_cache_pages is not None and not (
                0 <= self.donor_cache_pages < self.donor_pages):
            raise ValueError(
                f"donor_cache_pages={self.donor_cache_pages} must be >= 0 "
                f"and below the donor region ({self.donor_pages} pages) — "
                f"the fast tier mirrors a small hot subset, it cannot "
                f"replace the region")
        if self.registered_pages is not None and not (
                0 < self.registered_pages <= self.donor_pages):
            raise ValueError(
                f"registered_pages={self.registered_pages} must be > 0 "
                f"and at most the donor region ({self.donor_pages} pages) "
                f"— a donor must be able to register at least one page, "
                f"and cannot register more than it donated (use None to "
                f"disable the MR cache: every page pre-registered)")
        if self.mr_prefetch is not None:
            unknown = set(self.mr_prefetch) - {"depth", "degree",
                                               "confidence"}
            if unknown:
                raise ValueError(
                    f"unknown mr_prefetch keys: {sorted(unknown)} "
                    f"(valid: depth, degree, confidence)")
            if int(self.mr_prefetch.get("depth", 0)) < 0:
                raise ValueError("mr_prefetch depth must be >= 0 "
                                 "(0 disables prediction)")
            if int(self.mr_prefetch.get("degree", 1)) < 1:
                raise ValueError("mr_prefetch degree must be >= 1")
            if int(self.mr_prefetch.get("confidence", 1)) < 1:
                raise ValueError("mr_prefetch confidence must be >= 1")
        share = self.donor_pages // self.num_clients
        if not 0 <= self.heap_pages <= share:
            raise ValueError(
                f"heap_pages={self.heap_pages} must fit the per-client "
                f"donor-region slice of {share} pages "
                f"({self.donor_pages} pages / {self.num_clients} clients)")
        if self.sla is not None:
            if not isinstance(self.sla, str):
                if len(self.sla) != self.num_clients:
                    raise ValueError(
                        f"sla lists one class per client: got "
                        f"{len(self.sla)} names for {self.num_clients} "
                        f"clients (or pass a single name for all)")
            self.sla_for_clients()   # resolves + validates every class
        elif self.sla_classes:
            # overrides with nothing referencing them are a config typo
            raise ValueError("sla_classes given but sla is None — name "
                             "the classes clients should use via sla")
        return self

    # ---- SLA compilation ---------------------------------------------------
    def resolve_sla_class(self, name: str) -> SLAClass:
        """Resolve one class name to a validated ``SLAClass``.

        Resolution order: a registered ``sla`` policy (built-ins:
        ``premium``/``standard``/``best_effort``) instantiated with this
        spec's ``sla_classes[name]`` overrides, else a brand-new class
        built purely from ``sla_classes[name]``.

        Raises:
            ValueError: when ``name`` is neither registered nor defined
                in ``sla_classes``, or the class parameters are invalid.
        """
        from .policies import _REGISTRIES, create_policy   # lazy: cycle
        params = dict((self.sla_classes or {}).get(name, {}))
        if name in _REGISTRIES["sla"]:
            cls = create_policy("sla", PolicySpec(name, params))
        elif name in (self.sla_classes or {}):
            cls = SLAClass(name=name, **params)
        else:
            from .policies import policy_names
            raise ValueError(
                f"unknown SLA class {name!r}; registered: "
                f"{policy_names('sla')}, spec-defined: "
                f"{sorted(self.sla_classes or {})}")
        if not isinstance(cls, SLAClass):
            raise ValueError(f"sla policy {name!r} must produce an "
                             f"SLAClass, got {type(cls).__name__}")
        return cls.validate()

    def sla_for_clients(self) -> Optional[List[SLAClass]]:
        """Compile ``sla`` into one validated ``SLAClass`` per client
        (index-aligned with client endpoints), or None when unset."""
        if self.sla is None:
            return None
        names = ([self.sla] * self.num_clients
                 if isinstance(self.sla, str) else list(self.sla))
        return [self.resolve_sla_class(n) for n in names]

    # ---- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, PolicySpec):
                val = val.to_dict()
            elif isinstance(val, (dict, list)):
                val = json.loads(json.dumps(val))   # deep, JSON-safe copy
            out[f.name] = val
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ClusterSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown ClusterSpec fields: {sorted(unknown)}")
        return cls(**data)

    def to_json(self, **kwargs: Any) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def coerce(cls, value: Union[None, str, Dict[str, Any], "ClusterSpec"]
               ) -> "ClusterSpec":
        """None → defaults; dict → from_dict; str → from_json."""
        if value is None:
            return cls()
        if isinstance(value, ClusterSpec):
            return value
        if isinstance(value, dict):
            return cls.from_dict(value)
        if isinstance(value, str):
            return cls.from_json(value)
        raise TypeError(f"cannot build ClusterSpec from "
                        f"{type(value).__name__}")

    # ---- compiled views ----------------------------------------------------
    def link_config(self) -> Optional[LinkConfig]:
        return None if self.link is None else LinkConfig(**self.link)

    def fault_plan(self) -> Optional[FaultPlan]:
        if not self.faults:
            return None
        return fault_plan_from_dicts(self.faults, seed=self.seed)
