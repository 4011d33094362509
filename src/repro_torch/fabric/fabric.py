"""The Fabric — per-node NICs, links, and fault state for one cluster.

The seed engine had a single client-side ``SimulatedNIC`` built inside
``RDMABox.__init__``; donors were bare byte arrays. That cannot model the
deployment the paper actually measures (§7.1: one client paging against N
donors, replication because donors fail). RDMAvisor (arXiv:1802.01870)
draws the same conclusion for real clusters: RDMA resources must live
per-node behind one service layer.

A ``Fabric`` owns:

* one ``SimulatedNIC`` per node — client *and* donors (donor NICs start
  their processing units lazily, so idle donors cost no threads),
* one ``Link`` per directed node pair, created on demand from a default
  ``LinkConfig`` (overridable per pair with ``set_link``),
* one ``FaultState`` compiled from a ``FaultPlan``, consulted by every
  NIC on every transfer,
* the shared ``RegionDirectory`` and a ``DelayLine`` for propagation-
  delayed completion delivery.

``RDMABox`` takes a fabric endpoint instead of constructing its own NIC;
``repro_torch.box.open(ClusterSpec(...))`` is the builder facade most callers
use (``MemoryCluster`` survives only as its deprecation shim).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from .. import resolve_device
from ..core.nic import NICCostModel, ServiceConfig, SimulatedNIC
from ..core.region import CacheConfig, RegionDirectory, RemoteRegion
from ..core.registration import MRConfig
from .faults import FaultPlan, FaultState
from .link import DelayLine, Link, LinkConfig


class Fabric:
    def __init__(
        self,
        directory: Optional[RegionDirectory] = None,
        cost: Optional[NICCostModel] = None,
        scale: float = 1e-6,
        kernel_space: bool = True,
        link: Optional[LinkConfig] = None,
        faults: Optional[FaultPlan] = None,
        seed: int = 0,
        service: Optional[ServiceConfig] = None,
        cache: Optional[CacheConfig] = None,
        mr: Optional[MRConfig] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        """``device`` is where client-side buffers live (the session's
        device). It goes through ``repro_torch.resolve_device``: without a
        GPU it raises unless the caller passes ``"cpu"``. Donor regions
        stay in host memory, pinned when it is CUDA, so a device↔donor
        copy is a DMA."""
        self.directory = directory or RegionDirectory()
        self.device = resolve_device(device)
        self.pin_memory = self.device.type == "cuda"
        self.cost = cost or NICCostModel()
        self.scale = scale
        self.kernel_space = kernel_space
        self.link_cfg = link or LinkConfig()
        # donor-side service-plane policy shared by every NIC in the
        # fabric (DRR quantum, worker count, merging/ack-coalescing)
        self.service = service or ServiceConfig()
        # donor-side hot-page cache policy; every donated region gets a
        # tier built from it (None / capacity 0 = no tier, serve-from-
        # region exactly as before)
        self.cache = cache
        # donor-side MR-cache policy (registration-on-demand); None /
        # capacity 0 = every donor page pre-registered, as before
        self.mr = mr
        self.seed = seed
        self.origin = time.perf_counter()
        self.delay = DelayLine()
        self.faults = FaultState(faults, self.now_us)
        self._nics: Dict[int, SimulatedNIC] = {}
        self._links: Dict[Tuple[int, int], Link] = {}
        self._link_overrides: Dict[Tuple[int, int], LinkConfig] = {}
        self._lock = threading.Lock()
        self._closed = False

    def now_us(self) -> float:
        return (time.perf_counter() - self.origin) / self.scale

    # ---- topology ----------------------------------------------------------
    def add_node(self, node_id: int, donor_pages: int = 0,
                 cost: Optional[NICCostModel] = None,
                 kernel_space: Optional[bool] = None) -> SimulatedNIC:
        """Add a node (idempotent). ``donor_pages > 0`` also donates a
        memory region of that size to the cluster directory."""
        with self._lock:
            nic = self._nics.get(node_id)
            if nic is None:
                nic = SimulatedNIC(
                    node_id, self.directory,
                    cost=cost or self.cost, scale=self.scale,
                    kernel_space=(self.kernel_space if kernel_space is None
                                  else kernel_space),
                    fabric=self, origin=self.origin,
                    service=self.service, device=self.device,
                )
                self._nics[node_id] = nic
        if donor_pages > 0 and node_id not in self.directory:
            # never re-register: replacing the region would zero the
            # donor's memory under live swapped-out pages
            region = RemoteRegion(node_id, donor_pages,
                                  pin_memory=self.pin_memory)
            if self.cache is not None:
                region.cache = self.cache.build(region)
            if self.mr is not None:
                region.mr = self.mr.build(region)
            self.directory.register(region)
        return nic

    def nic(self, node_id: int) -> SimulatedNIC:
        with self._lock:
            if node_id not in self._nics:
                raise KeyError(f"node {node_id} not in fabric "
                               f"(have {sorted(self._nics)})")
            return self._nics[node_id]

    def nic_or_none(self, node_id: int) -> Optional[SimulatedNIC]:
        """The node's NIC, or None when the node has no NIC in this fabric
        (legacy directories register bare regions without a serving node —
        those transfers complete client-side)."""
        with self._lock:
            return self._nics.get(node_id)

    def nodes(self) -> List[int]:
        with self._lock:
            return sorted(self._nics)

    def peers_of(self, node_id: int) -> List[int]:
        return [n for n in self.nodes() if n != node_id]

    def set_link(self, src: int, dst: int, cfg: LinkConfig) -> None:
        """Override the link config for one directed pair (before traffic)."""
        with self._lock:
            self._link_overrides[(src, dst)] = cfg
            self._links.pop((src, dst), None)

    def link(self, src: int, dst: int) -> Link:
        with self._lock:
            key = (src, dst)
            ln = self._links.get(key)
            if ln is None:
                cfg = self._link_overrides.get(key, self.link_cfg)
                ln = Link(src, dst, cfg, self.scale, self.origin,
                          seed=self.seed)
                self._links[key] = ln
            return ln

    # ---- fault control -----------------------------------------------------
    def crash(self, node: int) -> None:
        """Imperative mid-run donor crash (same effect as FaultPlan.crash)."""
        self.faults.crash_node(node)

    def recover(self, node: int) -> None:
        self.faults.recover_node(node)

    def congest(self, src: int, dst: int, factor: float,
                until_us: Optional[float] = None) -> None:
        """Imperative congestion episode on one directed link (mid-run)."""
        self.faults.congest_link(src, dst, factor, until_us=until_us)

    def clear_congestion(self, src: int, dst: int) -> None:
        self.faults.clear_congestion(src, dst)

    # ---- lifecycle ---------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Fabric-level stats node (links, donor-side service, faults) —
        per-NIC counters live under the session tree's ``nic.*``
        namespace, see ``nic_snapshots``."""
        with self._lock:
            service = {}
            for n, nic in self._nics.items():
                fs = nic.fairness_snapshot()
                if fs:
                    service[n] = fs
            links = [ln.snapshot() for ln in self._links.values()]
        return {"links": links, "service": service,
                "faults": self.faults.snapshot()}

    def nic_snapshots(self) -> Dict[int, Dict[str, object]]:
        """Per-NIC counters plus the service-plane sub-node — the session
        tree's ``nic.<node>.*`` namespace (``nic.<node>.service.*`` holds
        per-worker served WQEs/bytes and merge/ack-coalescing counters)."""
        with self._lock:
            return {n: {**nic.stats.snapshot(),
                        "service": nic.service_snapshot()}
                    for n, nic in self._nics.items()}

    def stats(self) -> Dict[str, object]:
        """Legacy flat shape (``nics`` folded in)."""
        return {"nics": self.nic_snapshots(), **self.snapshot()}

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            nics = list(self._nics.values())
        for nic in nics:
            nic.close()
        self.delay.close()

    def __enter__(self) -> "Fabric":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
