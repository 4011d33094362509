"""``MemoryCluster`` — deprecation shim over ``repro_torch.box``.

The original fabric-builder facade survives with its full legacy
surface (``.box``/``.paging``/``.boxes``/``.pagings``, fault
choreography, flat ``stats()``), but it is now a thin veneer: the kwargs
compile into a ``ClusterSpec`` and a ``repro_torch.box.Session`` does the
actual wiring. New code should call ``repro_torch.box.open`` directly — the
Session adds handle-based remote memory, policy-by-name selection, and
the composed stats tree this shim cannot express. ``device`` is the
session's (client buffers there, donor memory on the host).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .._deprecation import warn_once
from ..core import (
    AdmissionHook,
    BoxConfig,
    DiskTier,
    RDMABox,
    RemotePagingSystem,
)
from ..fabric import FaultPlan, LinkConfig


class MemoryCluster:
    def __init__(self, num_donors: int = 3, donor_pages: int = 16384,
                 box_config: Optional[BoxConfig] = None,
                 replication: int = 2, client_node: int = 0,
                 num_clients: int = 1,
                 link: Optional[LinkConfig] = None,
                 faults: Optional[FaultPlan] = None,
                 stripe_pages: int = 16,
                 write_through_disk: bool = False,
                 first_responder: bool = False,
                 evict_after: int = 3,
                 disk: Optional[DiskTier] = None,
                 admission_hook_factory: Optional[
                     Callable[[], AdmissionHook]] = None,
                 seed: int = 0, device: str = "cuda") -> None:
        warn_once(
            "MemoryCluster",
            "MemoryCluster is deprecated; use repro_torch.box.open(ClusterSpec(...)) "
            "— see the README 'Public API' section for the migration map")
        # deferred: repro_torch.box imports repro_torch.memory for the capability bases
        from ..box import ClusterSpec, Session
        spec = ClusterSpec(
            num_donors=num_donors, donor_pages=donor_pages,
            num_clients=num_clients, client_node=client_node,
            replication=replication, stripe_pages=stripe_pages,
            heap_pages=0,               # legacy layout: whole slice to paging
            write_through_disk=write_through_disk,
            first_responder=first_responder, evict_after=evict_after,
            seed=seed)
        self._session = Session(
            spec,
            box_config=box_config or BoxConfig(),
            fault_plan=faults, link_config=link, disk=disk,
            admission_hook_factory=admission_hook_factory, device=device)
        self.fabric = self._session.fabric
        self.clients: List[int] = self._session.clients
        self.donors: List[int] = self._session.donors
        self.donor_pages = donor_pages
        self.boxes: List[RDMABox] = self._session._boxes
        self.pagings: List[RemotePagingSystem] = self._session._pagings
        self.box = self.boxes[0]
        self.paging = self.pagings[0]
        self.directory = self.fabric.directory

    # ---- fault choreography (delegates to the session) ---------------------
    def crash_donor(self, node: int) -> None:
        """Mid-run donor crash: transfers to ``node`` start erroring with
        RETRY_EXC_ERR; the paging layer detects, strikes, and evicts."""
        self._session.crash_donor(node)

    def recover_donor(self, node: int) -> None:
        self._session.recover_donor(node)

    def congest_path(self, client: int, donor: int, factor: float,
                     until_us: Optional[float] = None) -> None:
        """Congestion episode on one client↔donor path — both directions,
        so the forward data leg AND the donor's ack leg degrade (the
        signal the congestion-aware admission hook reacts to)."""
        self._session.congest_path(client, donor, factor, until_us=until_us)

    def clear_path(self, client: int, donor: int) -> None:
        self._session.clear_path(client, donor)

    def flush(self, timeout: float = 30.0) -> None:
        """Drain every client engine: event-driven per-box flush (each box
        sleeps on its futures-table condition variable — no poll loop)."""
        self._session.flush(timeout=timeout)

    def stats(self) -> dict:
        """Legacy flat shape; ``repro_torch.box.Session.stats()`` returns the
        namespaced tree instead."""
        out = {"box": self.box.stats(), "paging": self.paging.stats(),
               "fabric": self.fabric.stats()}
        if len(self.boxes) > 1:
            out["clients"] = {node: {"box": box.stats(),
                                     "paging": paging.stats()}
                              for node, box, paging in
                              zip(self.clients, self.boxes, self.pagings)}
        return out

    def close(self) -> None:
        self._session.close()

    def __enter__(self) -> "MemoryCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
