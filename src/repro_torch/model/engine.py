"""The analytic evaluation engine: compose centers along the simulator's
charged paths and solve them in closed form.

``evaluate(spec, workload)`` mirrors, one to one, the resources the
threaded engine charges for a request (see ``core/nic.py``):

* client poster (preMR memcpy or dynMR registration + doorbell MMIO —
  charged *before* the post stamp, so it loads its center but is
  excluded from latency, exactly like the simulator),
* client PU (``wqe_proc_us`` per WQE, amortized by the merge factor),
* client egress wire (``wire_us_per_page`` per payload page, plus the
  WQE-cache refetch penalty when the estimated outstanding count
  exceeds the on-NIC cache),
* the data link (optional bandwidth cap + pure propagation delay),
* donor ingress PU pool (``serve_workers`` capped at the modeled PU
  count; cache hits pay ``cache_hit_proc_us``, MR faults add
  ``reg_cost_us`` and a replay visit — the fault → register → RNR
  replay arc of the MR cache),
* donor region bandwidth (miss pages only; the coalesced ack's
  ``completion_dma_us`` rides the same shared wire, amortized by the
  estimated run length),
* the reverse (ack) link, and — for write-through specs — the disk.

Traffic splits come from the declared workload: the zipf top-share
estimate supplies the hot-page-cache hit rate (READ WQEs whose pages
are all resident) and the MR-cache warm rate (extents already
registered); ``spec.replication`` multiplies donor-side write visits
when the workload declares paging semantics.

Symmetric instances (clients of one SLA class, the donors) are solved
once and reported with a ``count`` — a 500-client x 64-donor grid point
costs microseconds, not threads.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.descriptors import PAGE_SIZE, RegMode
from ..core.nic import NICCostModel, ServiceConfig, SLOServiceConfig
from .centers import (
    Center,
    CenterDisk,
    CenterEstimate,
    CenterLink,
    CenterPU,
    CenterRegionBW,
    CenterWire,
)
from .workload import ModelWorkload, zipf_top_share

# quantiles of the queueing (exponential-tail) component
_LN2 = math.log(2.0)
_LN100 = math.log(100.0)
_LN1000 = math.log(1000.0)


@dataclass
class ClassReport:
    """Per-request-class estimates (one SLA class = one request class)."""

    name: str
    clients: int
    offered_ops_per_s: float       # per client, virtual seconds
    achieved_ops_per_s: float      # per client, capacity-clamped
    bytes_per_s: float             # per client payload rate
    det_us: float                  # deterministic path component
    wait_us: float                 # mean queueing component
    mean_us: float
    p50_us: float
    p99_us: float
    p999_us: float
    max_us: float
    mr_fault_rate: float

    def latency_snapshot(self) -> Dict[str, float]:
        """Same leaf shape as ``LatencyHistogram.snapshot`` — estimates
        carry ``count=0`` (they are closed-form, not samples)."""
        return {"count": 0, "mean_us": self.mean_us, "p50_us": self.p50_us,
                "p99_us": self.p99_us, "p999_us": self.p999_us,
                "max_us": self.max_us}


@dataclass
class ModelReport:
    """Everything one analytic evaluation produced."""

    classes: Dict[str, ClassReport]
    client_class: List[str]              # client index -> class name
    centers: Dict[str, CenterEstimate]
    warnings: Dict[str, list]            # {"saturated": [...], "notes": []}
    capacity_ops_per_s: float            # total, all clients
    bottleneck: str                      # first-saturated center name
    cache_hit_rate: float                # READ-WQE hot-tier hit estimate
    mr_hit_rate: float                   # warm-extent estimate
    mr_prefetch_coverage: float = 0.0    # fault fraction absorbed in bg
    workload: ModelWorkload = None
    eval_ms: float = 0.0

    @property
    def saturated(self) -> bool:
        return bool(self.warnings.get("saturated"))


@dataclass
class _Path:
    """One class's walk through the center graph: deterministic service
    + propagation on the way, and the centers whose queues it waits in."""

    det_us: float = 0.0
    waits: List[Center] = field(default_factory=list)

    def add(self, center: Center, service_us: float,
            delay_us: float = 0.0) -> None:
        self.det_us += service_us + delay_us
        if center is not None:
            self.waits.append(center)


def _resolved_premr(cost: NICCostModel, spec, pages: int) -> bool:
    """Mirror ``resolve_reg_mode``: AUTO picks preMR below the Fig. 4
    crossover (kernel-space dynMR is near-free, so AUTO picks dynMR)."""
    mode = RegMode(spec.reg_mode)
    if mode is RegMode.PRE_MR:
        return True
    if mode is RegMode.DYN_MR:
        return False
    if spec.kernel_space:
        return False
    return pages < cost.crossover_pages()


def _spec_policies(spec) -> Tuple[ServiceConfig, int, int, int]:
    """(service policy, cache pages, mr pages, prefetch depth) with the
    spec's engine knobs applied — the same resolution
    ``Session.__init__`` performs."""
    from ..box.policies import create_policy
    service = create_policy("service", spec.service)
    if not isinstance(service, ServiceConfig):
        service = ServiceConfig()      # custom policies: model the default
    if spec.serve_workers is not None:
        from dataclasses import replace
        service = replace(service, workers=spec.serve_workers)
    cache_pages = spec.donor_cache_pages
    if cache_pages is None:
        cache = create_policy("cache", spec.cache)
        cache_pages = getattr(cache, "capacity_pages", 0) or 0
    mr = create_policy("mr", spec.mr)
    mr_pages = spec.registered_pages
    if mr_pages is None:
        mr_pages = getattr(mr, "capacity_pages", 0) or 0
    prefetch_depth = getattr(mr, "prefetch_depth", 0) or 0
    if spec.mr_prefetch is not None:
        prefetch_depth = int(spec.mr_prefetch.get("depth", prefetch_depth))
    return service, cache_pages, mr_pages, prefetch_depth


def evaluate(spec, workload: Optional[ModelWorkload] = None,
             link_config=None) -> ModelReport:
    """Solve the center graph for ``spec`` under ``workload``.

    ``workload.client_ops_per_s=None`` runs a unit-rate probe first and
    re-evaluates at ``target_utilization`` of the probed bottleneck —
    the default "near the knee" operating point.
    """
    t0 = time.perf_counter()
    spec.validate()
    wl = ModelWorkload.coerce(workload).validate()
    if wl.client_ops_per_s is None:
        probe = _evaluate_at(spec, wl.with_rate(1.0), link_config)
        max_rho = max((c.utilization for c in probe.centers.values()),
                      default=0.0)
        rate = (wl.target_utilization / max_rho) if max_rho > 0.0 else 1.0
        report = _evaluate_at(spec, wl.with_rate(rate), link_config)
    else:
        report = _evaluate_at(spec, wl, link_config)
    report.eval_ms = (time.perf_counter() - t0) * 1e3
    return report


def _evaluate_at(spec, wl: ModelWorkload, link_config,
                 extra_wire_us: float = 0.0) -> ModelReport:
    cost = NICCostModel(**(spec.nic_cost or {}))
    service, cache_pages, mr_pages, prefetch_depth = _spec_policies(spec)
    workers = min(service.num_workers(cost.num_pus), cost.num_pus)
    link = link_config if link_config is not None else spec.link_config()
    link_latency_us = link.latency_us if link is not None else 1.0
    link_us_per_page = link.us_per_page() if link is not None else None

    # ---- request classes (one per SLA class; unlabelled = "default") ------
    sla = spec.sla_for_clients()
    if sla is None:
        client_class = ["default"] * spec.num_clients
        weights = {"default": 1.0}
    else:
        client_class = [c.name for c in sla]
        weights = {c.name: (c.weight
                            if isinstance(service, SLOServiceConfig) else 1.0)
                   for c in sla}
    clients_of: Dict[str, int] = {}
    for name in client_class:
        clients_of[name] = clients_of.get(name, 0) + 1

    # ---- traffic shape -----------------------------------------------------
    rate_us = wl.client_ops_per_s / 1e6          # per-client ops per vus
    pages = wl.pages_per_op
    op_bytes = pages * PAGE_SIZE
    rf = wl.read_fraction
    working_set = wl.working_set_pages or spec.donor_pages
    # hot-page tier: READ WQEs whose pages are ALL resident hit
    page_share = zipf_top_share(working_set, cache_pages, wl.zipf_s)
    read_hit = page_share ** pages if cache_pages else 0.0
    cache_hit_rate = rf * read_hit
    # MR cache: a WQE whose extent is registered is warm; a cold extent
    # faults, registers, and replays (one extra pass over the path)
    mr_share = (zipf_top_share(working_set, mr_pages, wl.zipf_s) ** pages
                if mr_pages else 1.0)
    fault_raw = (1.0 - mr_share) if mr_pages else 0.0
    # stride prefetch: the covered traffic fraction's faults become
    # background registrations — off the critical path, still PU load
    coverage = (wl.stride_fraction
                if (mr_pages and prefetch_depth > 0) else 0.0)
    fault = fault_raw * (1.0 - coverage)
    # donor-side visit multiplier: paging-style writes land on
    # ``replication`` donors; reads on one
    donor_visits = rf + (1.0 - rf) * (spec.replication
                                      if wl.replicate_writes else 1)
    wqe_rate = rate_us / wl.merge_factor          # client WQEs per vus
    wqe_pages = pages * wl.merge_factor           # pages per posted WQE

    notes: List[str] = []
    if not spec.donor_nics:
        notes.append("donor_nics=False: modeled as a served topology "
                     "(bare-region completion has no donor plane)")
    if spec.faults:
        notes.append("declarative fault events are ignored by the model "
                     "backend (steady-state analysis)")

    # ---- center graph ------------------------------------------------------
    centers: Dict[str, Center] = {}

    def center(key: str, factory, **kw) -> Center:
        c = centers.get(key)
        if c is None:
            c = centers[key] = factory(
                name=key, arrival_cv2=wl.arrival_cv2,
                service_cv2=wl.service_cv2, **kw)
        return c

    paths: Dict[str, _Path] = {}
    replay = 1.0 + fault                 # visit multiplier from MR replays
    # pre-pass ingress utilization (linear, no queueing) sizes the
    # donor-side run length the ack coalescing amortizes over
    donor_wqe_rate = (sum(clients_of[c] for c in clients_of) * wqe_rate
                      * donor_visits * replay / spec.num_donors)
    pu_demand_us = ((1.0 - cache_hit_rate) * cost.wqe_proc_us
                    + cache_hit_rate * cost.cache_hit_proc_us)
    rho_pre = donor_wqe_rate * pu_demand_us / workers
    if service.merge:
        backlog = 1.0 / (1.0 - min(rho_pre, 0.9))
        coalesce = max(1.0, min(backlog,
                                service.quantum_bytes / max(1, op_bytes)))
    else:
        coalesce = 1.0

    for cls, n in clients_of.items():
        lam = wqe_rate * replay          # per-client WQE rate incl. replays
        w = weights.get(cls, 1.0)
        path = paths[cls] = _Path()
        # poster: charged before the post stamp -> loads the center,
        # excluded from the latency path (post_v semantics)
        poster = center(f"client.{cls}.poster", CenterPU, servers=1, count=n)
        if _resolved_premr(cost, spec, pages):
            poster_us = cost.memcpy_cost_us(wqe_pages) / wl.merge_factor
        else:
            poster_us = (cost.reg_cost_us(wqe_pages, spec.kernel_space)
                         / wl.merge_factor)
        poster.add_visits(cls, lam, poster_us + cost.mmio_us, weight=w)
        # client PU: wqe_proc per posted WQE
        cpu = center(f"client.{cls}.pu", CenterPU,
                     servers=cost.num_pus, count=n)
        cpu_us = cost.wqe_proc_us / wl.merge_factor
        cpu.add_visits(cls, lam, cpu_us, weight=w)
        path.add(cpu, cpu_us)
        # client egress wire: payload pages serialize
        cwire = center(f"client.{cls}.wire", CenterWire, count=n)
        wire_us = pages * cost.wire_us_per_page + extra_wire_us
        cwire.add_visits(cls, lam, wire_us, weight=w)
        path.add(cwire, wire_us)
        # data link: per-path bandwidth cap + pure propagation
        dlink = center("link.data", CenterLink,
                       count=max(1, spec.num_clients * spec.num_donors),
                       delay_us=link_latency_us)
        lk_us = (pages * link_us_per_page) if link_us_per_page else 0.0
        dlink.add_visits(cls, lam / spec.num_donors, lk_us, weight=w)
        path.add(dlink if lk_us else None, lk_us, delay_us=link_latency_us)
        # donor ingress PU pool: cache-hit split + MR registration
        # stalls; per-instance arrival rate is the WHOLE class (n
        # clients) spread evenly over the donors
        dpu = center("donor.ingress_pu", CenterPU,
                     servers=workers, count=spec.num_donors)
        d_rate = n * lam * donor_visits / spec.num_donors
        dpu.add_visits(cls, d_rate, pu_demand_us, weight=w)
        if fault:
            dpu.add_visits(
                cls, n * wqe_rate * donor_visits * fault / spec.num_donors,
                cost.reg_cost_us(wqe_pages, spec.kernel_space), weight=w)
        if fault_raw and coverage:
            # covered faults: registration still burns donor PU time
            # (the idle-worker prefetch jobs) but never stalls a request
            dpu.add_visits(
                cls, n * wqe_rate * donor_visits * fault_raw * coverage
                / spec.num_donors,
                cost.reg_cost_us(wqe_pages, spec.kernel_space), weight=w)
        path.add(dpu, pu_demand_us)
        # donor region bandwidth: miss pages + the amortized ack DMA
        rbw = center("donor.region_bw", CenterRegionBW,
                     count=spec.num_donors)
        region_pages = pages * ((1.0 - rf) + rf * (1.0 - read_hit))
        region_us = region_pages * cost.wire_us_per_page
        ack_us = cost.completion_dma_us / coalesce
        rbw.add_visits(cls, d_rate, region_us + ack_us, weight=w)
        path.add(rbw, region_us + ack_us)
        # ack link back: propagation only (64B control message)
        path.add(None, 0.0, delay_us=link_latency_us)
        # disk tier: write-through persists every write
        if spec.write_through_disk:
            disk = center(f"client.{cls}.disk", CenterDisk, count=n)
            disk_us = spec.disk_latency_us
            disk.add_visits(cls, rate_us * (1.0 - rf), disk_us, weight=w)
            path.add(disk, (1.0 - rf) * disk_us)

    # ---- solve -------------------------------------------------------------
    estimates = {name: c.solve() for name, c in centers.items()}
    max_rho = max((e.utilization for e in estimates.values()), default=0.0)
    bottleneck = max(estimates.values(),
                     key=lambda e: e.utilization).name if estimates else ""
    total_rate = spec.num_clients * rate_us
    capacity = (total_rate / max_rho * 1e6) if max_rho > 0.0 else 0.0
    shed = min(1.0, 1.0 / max_rho) if max_rho > 0.0 else 1.0
    saturated = sorted(e.name for e in estimates.values() if e.saturated)

    reports: Dict[str, ClassReport] = {}
    for cls, path in paths.items():
        wait = sum(c.wait_us(cls) for c in path.waits)
        det = path.det_us
        mean = det + wait
        p50 = det + wait * _LN2
        p99 = det + wait * _LN100
        p999 = det + wait * _LN1000
        peak = p999
        if fault:
            # a faulted op pays the NAK arc, registration, the bounded
            # RNR backoff, and a full replay pass
            stall = (cost.reg_cost_us(wqe_pages, spec.kernel_space)
                     + spec.rnr_backoff_us + det)
            mean += fault * stall
            peak = max(peak, det + stall + wait)
            if fault >= 0.01:
                p99 = max(p99, det + stall)
            if fault >= 0.001:
                p999 = max(p999, det + stall)
        reports[cls] = ClassReport(
            name=cls, clients=clients_of[cls],
            offered_ops_per_s=rate_us * 1e6,
            achieved_ops_per_s=rate_us * shed * 1e6,
            bytes_per_s=rate_us * shed * 1e6 * op_bytes,
            det_us=det, wait_us=wait, mean_us=mean, p50_us=p50,
            p99_us=p99, p999_us=p999, max_us=peak, mr_fault_rate=fault)

    # outstanding-WQE estimate (Little's law) vs the on-NIC WQE cache
    mean_all = sum(r.mean_us * r.clients for r in reports.values()) \
        / max(1, spec.num_clients)
    outstanding = wqe_rate * replay * mean_all
    if outstanding > cost.wqe_cache_entries:
        if extra_wire_us == 0.0:
            # the overflow fraction of WQEs refetches from host memory
            # before hitting the wire (Fig. 1) — charge it as extra
            # egress serialization and re-solve once at the slower rate
            thrash = 1.0 - cost.wqe_cache_entries / outstanding
            return _evaluate_at(spec, wl, link_config,
                                extra_wire_us=thrash * cost.cache_miss_us)
        notes.append(
            f"estimated {outstanding:.0f} outstanding WQEs per client "
            f"exceed the {cost.wqe_cache_entries}-entry WQE cache — the "
            f"simulated engine would thrash (Fig. 1); latencies include "
            f"a {extra_wire_us:.2f}us per-WQE refetch penalty")
    if spec.window_bytes is not None and \
            outstanding * op_bytes > spec.window_bytes:
        notes.append(
            f"offered rate needs ~{outstanding * op_bytes:.0f} in-flight "
            f"bytes, over the {spec.window_bytes}-byte admission window "
            f"— the simulated engine would throttle below this rate")

    return ModelReport(
        classes=reports, client_class=client_class, centers=estimates,
        warnings={"saturated": saturated, "notes": notes},
        capacity_ops_per_s=capacity, bottleneck=bottleneck,
        cache_hit_rate=cache_hit_rate,
        mr_hit_rate=mr_share if mr_pages else 1.0,
        mr_prefetch_coverage=coverage,
        workload=wl)
