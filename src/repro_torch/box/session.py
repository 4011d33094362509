"""The ``Session`` facade — one object owning a whole cluster's lifetime.

``repro_torch.box.open(spec)`` compiles a declarative ``ClusterSpec`` into a
running fabric (per-node NICs, links, fault state), one engine per
client, and the per-client paging/heap layout, then hands back a
``Session`` that:

* owns lifecycle — context manager, idempotent ``close()`` that cascades
  to every capability object and fails in-flight transfers with
  ``ClosedError`` instead of letting waiters hit timeouts;
* hands out typed capabilities (``heap``/``pager``/``tensors``/
  ``kv_store``; ``engine`` exposes the raw node-level ``RDMABox`` for
  page-addressed workloads and benchmarks);
* composes ONE stats tree (``stats()``) with stable namespaces —
  ``fabric.*`` (links, donor-side service, faults), ``nic.<node>.*``
  (per-NIC counters), ``client.<i>.box.*`` (per-engine merge/admission/
  poll state, plus ``client.<i>.paging`` / ``.heap`` / ``.tensors``),
  and ``paging.*`` (client 0's paging view) — replacing the divergent
  per-class dicts of the pre-``repro_torch.box`` surface;
* drives scenario choreography (``crash_donor``/``recover_donor``/
  ``congest_path``/``clear_path``) against the fabric's fault state.

The session's ``device`` is where client-side buffers live: the
``kv_store`` pool, the outputs of reads, swap-ins and fetches. Donor
memory (regions, hot-page frames) stays in host memory, pinned when the
device is CUDA.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from .. import resolve_device
from ..core.admission import AdmissionHook, CongestionAwareHook
from ..core.descriptors import PAGE_SIZE, RegMode
from ..core.errors import BoxError, ClosedError
from ..core.nic import NICCostModel, ServiceConfig, SLOServiceConfig
from ..core.region import CacheConfig
from ..core.registration import MRConfig
from ..core.paging import DiskTier, RemotePagingSystem
from ..core.rdmabox import BoxConfig, RDMABox
from ..fabric import Fabric, FaultPlan, LinkConfig
from .handles import KVStore, Pager, RemoteHeap, TensorStore
from .policies import create_policy
from .spec import VALID_BACKENDS, ClusterSpec
from .stats import flatten_stats

# keyword arguments of open() that are Session escape hatches (imperative
# objects the declarative spec cannot carry), not ClusterSpec fields
ESCAPE_HATCHES = ("box_config", "fault_plan", "link_config", "disk",
                  "admission_hook_factory", "app_handler")


class _SessionBox(RDMABox):
    _box_internal = True


class _SessionPaging(RemotePagingSystem):
    _box_internal = True


class Session:
    """A running cluster plus the capability objects layered on it."""

    def __init__(self, spec: Optional[ClusterSpec] = None, *,
                 box_config: Optional[BoxConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 link_config: Optional[LinkConfig] = None,
                 disk: Optional[DiskTier] = None,
                 admission_hook_factory: Optional[
                     Callable[[], AdmissionHook]] = None,
                 app_handler: Optional[Callable] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        spec = ClusterSpec.coerce(spec).validate()
        self.spec = spec
        self.device = resolve_device(device)
        self._closed = False
        cfg = box_config
        if cfg is None:
            poll = create_policy("polling", spec.polling)
            cfg = BoxConfig(
                channels_per_peer=spec.channels_per_peer,
                batch_policy=create_policy("batching", spec.batching),
                reg_mode=RegMode(spec.reg_mode),
                kernel_space=spec.kernel_space,
                window_bytes=spec.window_bytes,
                max_drain=spec.max_drain,
                poll=poll,
                nic_cost=NICCostModel(**(spec.nic_cost or {})),
                nic_scale=spec.nic_scale,
                app_handler=app_handler,
                rnr_retry_limit=spec.rnr_retry_limit,
                rnr_backoff_us=spec.rnr_backoff_us,
                rnr_jitter_seed=spec.rnr_jitter_seed,
            )
        else:
            if spec.num_clients > 1 and cfg.admission_hook is not None \
                    and admission_hook_factory is None:
                raise ValueError(
                    "BoxConfig.admission_hook is one stateful object — "
                    "sharing it across clients would merge their latency "
                    "signals; pass admission_hook_factory so each client "
                    "gets its own hook")
            if app_handler is not None:     # merge, don't silently drop
                cfg = replace(cfg, app_handler=app_handler)
        self._cfg = cfg

        # donor-side service plane: the ``service`` policy supplies the
        # ServiceConfig (DRR quantum, merging, ack coalescing); the
        # ``serve_workers`` engine knob overrides its worker count
        service = create_policy("service", spec.service)
        # SLA compilation: spec.sla names one class per client; the
        # compiled SLAClass objects parameterize BOTH halves of the SLO
        # story — per-client maps on the service policy (donor dispatch
        # order, weighted quanta, per-class stats attribution) here, and
        # per-client admission-hook protection below
        sla = spec.sla_for_clients()
        if sla is not None:
            nodes = [spec.client_node + i for i in range(spec.num_clients)]
            if isinstance(service, SLOServiceConfig):
                service = replace(
                    service,
                    client_class={n: c.name for n, c in zip(nodes, sla)},
                    client_weight={n: c.weight
                                   for n, c in zip(nodes, sla)},
                    client_priority={n: c.priority
                                     for n, c in zip(nodes, sla)},
                    client_deadline_us={n: c.p99_target_us
                                        for n, c in zip(nodes, sla)
                                        if c.p99_target_us is not None})
            elif isinstance(service, ServiceConfig):
                # plain DRR ignores weights/deadlines but still attributes
                # per-class serve stats
                service = replace(
                    service,
                    client_class={n: c.name for n, c in zip(nodes, sla)})
        if spec.serve_workers is not None:
            if not isinstance(service, ServiceConfig):
                # a silent no-op would leave the pool sized by the custom
                # policy while the spec (and stats readers) expect N
                raise ValueError(
                    f"serve_workers={spec.serve_workers} only applies to "
                    f"ServiceConfig-based service policies; the "
                    f"{spec.service.name!r} policy is a "
                    f"{type(service).__name__} — set its worker count via "
                    f"the policy's own params instead")
            service = replace(service, workers=spec.serve_workers)
        # donor-side hot-page cache: the ``cache`` policy supplies the
        # CacheConfig (promotion threshold, CLOCK eviction); the
        # ``donor_cache_pages`` engine knob overrides its capacity
        cache = create_policy("cache", spec.cache)
        if spec.donor_cache_pages is not None:
            if not isinstance(cache, CacheConfig):
                # a silent no-op would leave the tier sized by the custom
                # policy while the spec (and stats readers) expect N
                raise ValueError(
                    f"donor_cache_pages={spec.donor_cache_pages} only "
                    f"applies to CacheConfig-based cache policies; the "
                    f"{spec.cache.name!r} policy is a "
                    f"{type(cache).__name__} — set its capacity via the "
                    f"policy's own params instead")
            cache = replace(cache, capacity_pages=spec.donor_cache_pages)
        # donor-side registration-on-demand: the ``mr`` policy supplies
        # the MRConfig (LRU capacity); the ``registered_pages`` engine
        # knob overrides its capacity
        mr = create_policy("mr", spec.mr)
        if spec.registered_pages is not None:
            if not isinstance(mr, MRConfig):
                # a silent no-op would leave the cache sized by the custom
                # policy while the spec (and stats readers) expect N
                raise ValueError(
                    f"registered_pages={spec.registered_pages} only "
                    f"applies to MRConfig-based mr policies; the "
                    f"{spec.mr.name!r} policy is a "
                    f"{type(mr).__name__} — set its capacity via the "
                    f"policy's own params instead")
            mr = replace(mr, capacity_pages=spec.registered_pages)
        if spec.mr_prefetch is not None:
            if not isinstance(mr, MRConfig):
                # a silent no-op would leave prediction configured by the
                # custom policy while the spec (and stats readers) expect
                # these knobs
                raise ValueError(
                    f"mr_prefetch={spec.mr_prefetch} only applies to "
                    f"MRConfig-based mr policies; the {spec.mr.name!r} "
                    f"policy is a {type(mr).__name__} — set its prefetch "
                    f"knobs via the policy's own params instead")
            pf = spec.mr_prefetch
            mr = replace(
                mr,
                prefetch_depth=int(pf.get("depth", mr.prefetch_depth)),
                prefetch_degree=int(pf.get("degree", mr.prefetch_degree)),
                prefetch_confidence=int(pf.get("confidence",
                                               mr.prefetch_confidence)))
        self.fabric = Fabric(
            cost=cfg.nic_cost, scale=cfg.nic_scale,
            kernel_space=cfg.kernel_space,
            link=link_config if link_config is not None
            else spec.link_config(),
            faults=fault_plan if fault_plan is not None
            else spec.fault_plan(),
            seed=spec.seed,
            service=service,
            cache=cache,
            mr=mr,
            device=self.device)
        self.directory = self.fabric.directory
        self.clients: List[int] = [spec.client_node + i
                                   for i in range(spec.num_clients)]
        self.donors: List[int] = [spec.client_node + spec.num_clients + i
                                  for i in range(spec.num_donors)]
        for node in self.donors:
            if spec.donor_nics:
                self.fabric.add_node(node, donor_pages=spec.donor_pages)
            elif node not in self.directory:
                # bare regions without a serving NIC: transfers complete
                # client-side (the microbenchmark fixture)
                from ..core.region import RemoteRegion
                self.directory.register(RemoteRegion(
                    node, spec.donor_pages,
                    pin_memory=self.fabric.pin_memory))

        # per-client engines + disjoint paging/heap slices of every donor
        share = spec.donor_pages // spec.num_clients
        paging_pages = share - spec.heap_pages
        self._heap_base = paging_pages          # offset within a slice
        self._share = share
        self._boxes: List[RDMABox] = []
        self._pagings: List[RemotePagingSystem] = []
        for i, node in enumerate(self.clients):
            client_cfg = cfg
            if admission_hook_factory is not None:
                client_cfg = replace(cfg,
                                     admission_hook=admission_hook_factory())
            elif box_config is None:
                hook = create_policy("admission", spec.admission)
                if sla is not None and isinstance(hook, CongestionAwareHook):
                    # the client's SLA class parameterizes its admission
                    # response: protected classes hold their window until
                    # their own p99 breaks the target, best-effort classes
                    # shed window on fewer ECN marks
                    hook.protected = sla[i].protected
                    hook.p99_target_us = sla[i].p99_target_us
                    hook.ecn_mark_fraction = sla[i].ecn_mark_fraction
                client_cfg = replace(cfg, admission_hook=hook)
            box = _SessionBox(node, peers=self.donors, config=client_cfg,
                              fabric=self.fabric)
            self._boxes.append(box)
            self._pagings.append(_SessionPaging(
                box, spec.donor_pages, replication=spec.replication,
                stripe_pages=spec.stripe_pages,
                disk=disk if disk is not None
                else DiskTier(latency_us=spec.disk_latency_us),
                write_through_disk=spec.write_through_disk,
                first_responder=spec.first_responder,
                evict_after=spec.evict_after,
                region_base=i * share, region_pages=paging_pages,
                placement=create_policy("placement", spec.placement)))
        self._heaps: Dict[int, RemoteHeap] = {}
        self._pagers: Dict[int, Pager] = {}
        self._tensors: Dict[int, TensorStore] = {}
        self._kv_stores: List[KVStore] = []

    # ---- lifetime ----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def _guard(self) -> None:
        if self._closed:
            raise ClosedError("Session is closed")

    def close(self) -> None:
        """Idempotent teardown, cascading to every capability: engines
        abort in-flight futures with ``ClosedError``, then the fabric
        (NICs, links, delay line) shuts down."""
        if self._closed:
            return
        self._closed = True
        for box in self._boxes:
            box.close()
        self.fabric.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def flush(self, timeout: float = 30.0) -> None:
        """Drain every client engine (event-driven per-box flush)."""
        self._guard()
        for box in self._boxes:
            box.flush(timeout=timeout)

    def _client_index(self, client: int) -> int:
        if not 0 <= client < len(self.clients):
            raise IndexError(f"client {client} out of range "
                             f"(num_clients={len(self.clients)})")
        return client

    # ---- capabilities ------------------------------------------------------
    def engine(self, client: int = 0) -> RDMABox:
        """The client's node-level engine (page-addressed advanced API).

        Raises ``IndexError`` for ``client`` outside
        ``[0, num_clients)`` and ``ClosedError`` after ``close()`` —
        the same contract as every capability accessor below."""
        self._guard()
        return self._boxes[self._client_index(client)]

    def heap(self, client: int = 0) -> RemoteHeap:
        """Handle-based remote memory; ``alloc`` raises ``AllocError``
        whenever ``spec.heap_pages`` is 0 or exhausted."""
        self._guard()
        i = self._client_index(client)
        if i not in self._heaps:
            self._heaps[i] = RemoteHeap(
                self, self._boxes[i], self.donors,
                heap_base=i * self._share + self._heap_base,
                heap_pages=self.spec.heap_pages)
        return self._heaps[i]

    def pager(self, client: int = 0) -> Pager:
        """The client's replicated remote paging system."""
        self._guard()
        i = self._client_index(client)
        if i not in self._pagers:
            self._pagers[i] = Pager(self, self._pagings[i])
        return self._pagers[i]

    def tensors(self, client: int = 0, **offload_opts: Any) -> TensorStore:
        """Tensor/pytree offload over the client's pager."""
        self._guard()
        i = self._client_index(client)
        if i not in self._tensors:
            from ..memory.offload import OffloadConfig
            cfg = OffloadConfig(**offload_opts) if offload_opts else None
            self._tensors[i] = TensorStore(self, self._pagings[i], cfg)
        elif offload_opts:
            raise ValueError("tensors() options are fixed at first call")
        return self._tensors[i]

    def kv_store(self, num_pages: int, page_tokens: int, kv_features: int,
                 dtype: torch.dtype = torch.float32, client: int = 0,
                 arena_pages: Optional[int] = None) -> KVStore:
        """A paged KV cache whose spill arena is RESERVED from the
        client's heap (``arena_pages``; default sized for one full pool
        spill), so spills never overlap ``heap().alloc`` buffers or other
        KVStores. Falls back to the raw donor regions (unreserved, legacy
        layout) when ``heap_pages == 0``. The pool lives on the
        session's device."""
        self._guard()
        i = self._client_index(client)
        page_bytes = page_tokens * kv_features * dtype.itemsize
        rdma_pages = max(1, -(-page_bytes // PAGE_SIZE))
        base, arena = 0, None
        if self.spec.heap_pages > 0:
            arena = arena_pages if arena_pages is not None \
                else num_pages * rdma_pages
            base = self.heap(i).reserve_range(arena)
        kv = KVStore(self, self._boxes[i], self.donors,
                     num_pages=num_pages, page_tokens=page_tokens,
                     kv_features=kv_features, dtype=dtype,
                     remote_base_page=base, arena_pages=arena)
        self._kv_stores.append(kv)
        return kv

    # ---- scenario choreography (delegates to the fabric) -------------------
    def crash_donor(self, node: int) -> None:
        """Mid-run donor crash: transfers to ``node`` start erroring with
        RETRY_EXC_ERR; the paging layer detects, strikes, and evicts."""
        self._guard()
        self.fabric.crash(node)

    def recover_donor(self, node: int) -> None:
        self._guard()
        self.fabric.recover(node)
        for paging in self._pagings:
            paging.recover_node(node)

    def congest_path(self, client_node: int, donor: int, factor: float,
                     until_us: Optional[float] = None) -> None:
        """Congestion episode on one client↔donor path — both directions,
        so the forward data leg AND the donor's ack leg degrade (and both
        carry ECN marks the admission hook can react to)."""
        self._guard()
        self.fabric.congest(client_node, donor, factor, until_us=until_us)
        self.fabric.congest(donor, client_node, factor, until_us=until_us)

    def clear_path(self, client_node: int, donor: int) -> None:
        self._guard()
        self.fabric.clear_congestion(client_node, donor)
        self.fabric.clear_congestion(donor, client_node)

    # ---- the one stats tree ------------------------------------------------
    def stats(self, flat: bool = False) -> Dict[str, Any]:
        """The composed, namespaced stats tree.

        ``fabric.*`` — links, donor-side service, fault state;
        ``nic.<node>.*`` — per-NIC counters (clients and donors);
        ``client.<i>.box.*`` — per-engine merge/admission/poll state
        (plus ``client.<i>.paging`` and, when materialized, ``.heap`` /
        ``.tensors`` / ``.kv``); ``paging.*`` — client 0's paging view.
        ``flat=True`` returns dotted keys instead of the nested tree.
        """
        self._guard()
        clients: Dict[str, Any] = {}
        for i, (box, paging) in enumerate(zip(self._boxes, self._pagings)):
            node: Dict[str, Any] = {"box": box.snapshot(),
                                    "paging": paging.snapshot()}
            if i in self._heaps:
                node["heap"] = self._heaps[i].snapshot()
            if i in self._tensors:
                node["tensors"] = self._tensors[i].snapshot()
            clients[str(i)] = node
        tree = {
            "fabric": self.fabric.snapshot(),
            "nic": {str(n): snap
                    for n, snap in self.fabric.nic_snapshots().items()},
            "client": clients,
            "paging": self._pagings[0].snapshot(),
        }
        if self._kv_stores:
            tree["kv"] = {str(i): kv.snapshot()
                          for i, kv in enumerate(self._kv_stores)}
        return flatten_stats(tree) if flat else tree


def open_session(spec: Union[None, str, Dict[str, Any], ClusterSpec] = None,
                 device: Union[str, torch.device] = "cuda", **kwargs: Any):
    """Build a session from a declarative spec.

    ``spec`` may be a ``ClusterSpec``, a plain dict, a JSON string, or
    None (defaults). Extra keyword arguments override spec fields
    (``open(spec, num_clients=4)``); the ``ESCAPE_HATCHES`` keywords pass
    imperative objects straight to ``Session`` for legacy/advanced use.

    ``device`` (not a spec field, so one spec's JSON opens in both
    packages) goes through ``repro_torch.resolve_device``: without a GPU
    it raises unless the caller passes ``"cpu"``. Client-side buffers
    live there; donor memory stays on the host, pinned for CUDA.

    ``spec.backend`` (or ``backend=`` as an override) selects the
    execution backend. ``"sim"`` starts the threaded simulator and
    returns a ``Session``; the analytic ``"model"`` backend is not
    ported yet (ROADMAP item 8(d)).

    Raises:
        BoxError: unknown ``backend``, ``backend="model"``, or
            ``workload=`` with the sim backend (the simulator measures
            traffic, it is not told one).
        RuntimeError: a CUDA ``device`` and no GPU.
    """
    hatches = {k: kwargs.pop(k) for k in ESCAPE_HATCHES if k in kwargs}
    workload = kwargs.pop("workload", None)
    spec = ClusterSpec.coerce(spec)
    if kwargs:
        spec = replace(spec, **kwargs)
    if spec.backend not in VALID_BACKENDS:
        raise BoxError(
            f"unknown backend {spec.backend!r}: valid backends are "
            f"'sim' (thread-per-NIC simulator) and 'model' (analytic "
            f"queueing-model evaluator)")
    if spec.backend == "model":
        raise BoxError(
            "backend=\"model\" (the analytic queueing-model evaluator) is "
            "not ported to repro_torch yet (ROADMAP item 8(d)); open with "
            "backend=\"sim\"")
    if workload is not None:
        raise BoxError(
            "workload= describes offered traffic to the model backend; "
            "the simulator measures what clients actually submit — drive "
            "session.engine(i) instead")
    return Session(spec, device=device, **hatches)


__all__ = ["ESCAPE_HATCHES", "Session", "open_session"]
