"""Pluggable policy registries for the ``repro_torch.box`` surface.

Eight policy kinds cover the engine's decision points; a ``ClusterSpec``
selects each by name (plus a parameter dict), so swapping a policy is a
config change, not rewiring:

* ``admission``  — the window-scaling hook (per-client instance).
  Built-ins: ``static`` (the paper prototype's fixed window),
  ``congestion`` (AIMD on latency EWMA + ECN-style fabric marks).
* ``polling``    — the WC-handling strategy (returns a ``PollConfig``).
  Built-ins: the paper's six (``adaptive``, ``busy``, ``event``,
  ``event_batch``, ``scq``, ``hybrid_timer``).
* ``batching``   — how drained merge-queue batches become NIC postings.
  Built-ins: ``single``, ``doorbell``, ``batch_on_mr``, ``hybrid``.
* ``placement``  — the paging layer's replica layout.
  Built-in: ``striped`` (the paper's layout).
* ``service``    — the donor-side service plane (returns a
  ``ServiceConfig``): DRR quantum, worker count, donor-side job merging
  and ack coalescing. Built-ins: ``drr``, ``slo`` (weighted +
  deadline-aware DRR driven by the clients' SLA classes).
  ``ClusterSpec.serve_workers`` overrides the worker count without
  replacing the policy.
* ``cache``      — the donor-side hot-page cache tier (returns a
  ``CacheConfig``, whose ``build(region)`` makes the per-region
  ``CacheTier``): capacity, promote-after-N-accesses threshold, CLOCK
  eviction. Built-in: ``freq-clock`` (capacity 0 = disabled).
  ``ClusterSpec.donor_cache_pages`` overrides the capacity without
  replacing the policy.
* ``mr``         — donor-side registration-on-demand (returns an
  ``MRConfig``, whose ``build(region)`` makes the per-region
  ``MRCache``): a bounded map of registered pages, lazy first-touch
  registration via fault → register → RNR replay, dereg-on-evict.
  Built-ins: ``lru`` (plain LRU; capacity 0 = disabled, every page
  pre-registered), ``slru`` (segmented LRU — probation/protected with a
  ``protected_fraction`` knob, so single-touch scans can't flush the
  hot set), ``freq-extent`` (frequency-aware whole-extent victims —
  pages registered together evict together). Every built-in accepts the
  ``prefetch_depth``/``prefetch_degree``/``prefetch_confidence`` knobs
  of the stride-stream prefetcher (depth 0 = prediction off).
  ``ClusterSpec.registered_pages`` overrides the capacity and
  ``ClusterSpec.mr_prefetch`` the prefetch knobs without replacing the
  policy.
* ``sla``       — named tenant service levels (returns an ``SLAClass``:
  dispatch weight, backlog priority, optional ``p99_target_us``
  contract, admission protection). Built-ins: ``premium``,
  ``standard``, ``best_effort``; ``ClusterSpec.sla_classes`` overrides
  parameters per spec without registering anything.

Third-party policies register via the decorator::

    @register_policy("placement", "rack-aware")
    class RackAware:
        def capacity_pages(self, ps): ...
        def replicas(self, ps, page_id): ...

and become selectable as ``ClusterSpec(placement="rack-aware")``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ..core.admission import AdmissionHook, CongestionAwareHook
from ..core.batching import BatchPolicy
from ..core.nic import ServiceConfig, SLOServiceConfig
from ..core.paging import StripedPlacement
from ..core.polling import PollConfig, PollMode
from ..core.region import CacheConfig
from ..core.registration import FreqExtentConfig, MRConfig, SLRUConfig
from .spec import PolicySpec, SLAClass

POLICY_KINDS = ("admission", "polling", "batching", "placement", "service",
                "cache", "mr", "sla")

_REGISTRIES: Dict[str, Dict[str, Callable[..., Any]]] = {
    kind: {} for kind in POLICY_KINDS
}


def register_policy(kind: str, name: str) -> Callable:
    """Class/function decorator registering a policy factory under
    ``kind``/``name``. The factory is called with the spec's parameter
    dict as keyword arguments each time a session needs an instance."""
    if kind not in _REGISTRIES:
        raise ValueError(f"unknown policy kind {kind!r} "
                         f"(one of {POLICY_KINDS})")

    def deco(factory: Callable[..., Any]) -> Callable[..., Any]:
        _REGISTRIES[kind][name] = factory
        return factory

    return deco


def policy_names(kind: str) -> List[str]:
    """Registered names for one policy kind."""
    return sorted(_REGISTRIES[kind])


def create_policy(kind: str, ref: PolicySpec) -> Any:
    """Instantiate the policy ``ref`` names (a fresh instance per call —
    admission hooks are stateful and must not be shared across clients)."""
    ref = PolicySpec.coerce(ref)
    try:
        factory = _REGISTRIES[kind][ref.name]
    except KeyError:
        raise ValueError(
            f"unknown {kind} policy {ref.name!r}; registered: "
            f"{policy_names(kind)}") from None
    return factory(**ref.params)


# ---- built-in admission policies ------------------------------------------
@register_policy("admission", "static")
def _static_admission() -> Optional[AdmissionHook]:
    """The prototype's fixed window: no hook at all."""
    return None


register_policy("admission", "congestion")(CongestionAwareHook)


# ---- built-in polling policies --------------------------------------------
def _poll_factory(mode: PollMode) -> Callable[..., PollConfig]:
    def make(**params: Any) -> PollConfig:
        return PollConfig(mode=mode, **params)
    return make


for _mode in PollMode:
    register_policy("polling", _mode.value)(_poll_factory(_mode))


# ---- built-in batching policies -------------------------------------------
def _batch_factory(policy: BatchPolicy) -> Callable[..., BatchPolicy]:
    def make() -> BatchPolicy:
        return policy
    return make


for _policy in BatchPolicy:
    register_policy("batching", _policy.value)(_batch_factory(_policy))


# ---- built-in placement policies ------------------------------------------
register_policy("placement", "striped")(StripedPlacement)


# ---- built-in service-plane policies ---------------------------------------
register_policy("service", "drr")(ServiceConfig)
register_policy("service", "slo")(SLOServiceConfig)


# ---- built-in donor-cache policies ------------------------------------------
register_policy("cache", "freq-clock")(CacheConfig)


# ---- built-in MR-cache policies ---------------------------------------------
register_policy("mr", "lru")(MRConfig)
register_policy("mr", "slru")(SLRUConfig)
register_policy("mr", "freq-extent")(FreqExtentConfig)


# ---- built-in SLA classes ---------------------------------------------------
def _sla_factory(**defaults: Any) -> Callable[..., SLAClass]:
    def make(**params: Any) -> SLAClass:
        return SLAClass(**{**defaults, **params})
    return make


# premium: 4x DRR credit, visited first under backlog, window protected
# until its own p99 breaks 5k vus; standard: 2x credit; best_effort: the
# pre-SLO default, plus a hair-trigger ECN response so it sheds window
# first when the fabric marks.
register_policy("sla", "premium")(_sla_factory(
    name="premium", weight=4.0, priority=2, p99_target_us=5000.0,
    protected=True))
register_policy("sla", "standard")(_sla_factory(
    name="standard", weight=2.0, priority=1))
register_policy("sla", "best_effort")(_sla_factory(
    name="best_effort", weight=1.0, priority=0, ecn_mark_fraction=0.25))
