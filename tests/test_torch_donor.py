"""repro_torch's donor service plane, hot-page cache, SLO serving and MR
cache, prefetch and replacement against the reference.

Twins of ``tests/test_donor_service.py``, ``test_hot_cache.py``,
``test_slo.py``, ``test_mr_cache.py``, ``test_mr_prefetch.py`` and
``test_mr_replacement.py`` on ``repro_torch`` with torch ``uint8`` buffers
on the CPU. Left without a twin (ROADMAP lists them): the tests whose
assertion is a wall-clock skew or latency ratio. The analytic
``backend="model"`` case is in ``tests/test_torch_model.py``. Last,
parity cases: one MR-cache trace and one hot-cache trace through both
packages give the same counters.
"""

import collections
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small buffers; leave the cores to parallel test workers

from benchmarks.common import (  # noqa: E402
    zipfian_pages,
    zipfian_weights,
    zipfian_working_set,
)
from repro_torch import box  # noqa: E402
from repro_torch.core import (  # noqa: E402
    PAGE_SIZE,
    BoxConfig,
    BoxError,
    CacheConfig,
    CacheTier,
    ExtentPrefetcher,
    FreqExtentConfig,
    FreqExtentMRCache,
    MRCache,
    MRConfig,
    RDMABox,
    RemoteRegion,
    ServiceConfig,
    SLRUConfig,
    SLRUMRCache,
    StagingPool,
    TransferDescriptor,
    TransferError,
    Verb,
    WCStatus,
    WorkRequest,
)
from repro_torch.core.admission import CongestionAwareHook  # noqa: E402
from repro_torch.core.completion import CompletionQueue  # noqa: E402
from repro_torch.core.descriptors import WorkCompletion  # noqa: E402
from repro_torch.core.nic import SLOServiceConfig, _DonorJob  # noqa: E402
from repro_torch.fabric import Fabric  # noqa: E402


def tb(a):
    """A numpy array's bytes as a CPU torch tensor (shared memory)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def full(n, value):
    return torch.full((n,), value, dtype=torch.uint8)


# ===========================================================================
# twins of tests/test_donor_service.py
# ===========================================================================

FAST = BoxConfig(nic_scale=2e-8)


def page(seed):
    return tb(np.random.default_rng(seed).integers(
        0, 255, PAGE_SIZE).astype(np.uint8))


# ---------------------------------------------------------------------------
# spec / policy plumbing
# ---------------------------------------------------------------------------

def test_serve_workers_roundtrips_through_spec():
    spec = box.ClusterSpec(serve_workers=2,
                           service={"name": "drr",
                                    "params": {"quantum_bytes": 8 * PAGE_SIZE,
                                               "coalesce_acks": False}})
    again = box.ClusterSpec.from_json(spec.to_json())
    assert again == spec
    assert again.serve_workers == 2
    assert again.service.params["quantum_bytes"] == 8 * PAGE_SIZE
    assert box.ClusterSpec().serve_workers is None   # default: one per PU


def test_serve_workers_validation():
    with pytest.raises(ValueError, match="serve_workers"):
        box.ClusterSpec(serve_workers=0).validate()


def test_spec_knob_reaches_the_nics():
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, serve_workers=3)
    with box.open(spec, device="cpu") as s:
        donor_nic = s.fabric.nic(s.donors[0])
        assert donor_nic.serve_workers == 3
        assert s.fabric.service.merge and s.fabric.service.coalesce_acks
    # None sizes the pool to the cost model's PU count
    assert ServiceConfig().num_workers(4) == 4
    assert ServiceConfig(workers=1).num_workers(4) == 1


def test_serve_workers_override_rejects_non_drr_policy():
    """A custom (non-ServiceConfig) service policy with serve_workers set
    must fail loudly, not silently ignore the knob."""
    from repro_torch.box.policies import register_policy

    class NotAServiceConfig:
        def num_workers(self, num_pus):
            return 1

    register_policy("service", "custom-svc-for-test")(NotAServiceConfig)
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, serve_workers=8,
                           service="custom-svc-for-test")
    with pytest.raises(ValueError, match="serve_workers=8 only applies"):
        box.open(spec, device="cpu")


# ---------------------------------------------------------------------------
# parallel service: workers actually spread, data stays intact
# ---------------------------------------------------------------------------

def test_parallel_workers_spread_service_and_preserve_data():
    spec = box.ClusterSpec(num_donors=1, donor_pages=4096, replication=1,
                           num_clients=2, nic_scale=2e-8, serve_workers=4)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        datas = {}
        futs = []
        for i in range(2):
            eng = s.engine(i)
            base = 2048 * i
            for j in range(48):
                d = page(100 * i + j)
                datas[(i, base + 2 * j)] = d
                futs.append(eng.write(donor, base + 2 * j, d))
        for f in futs:
            f.wait(10)
        for (i, addr), d in datas.items():
            out = torch.zeros(PAGE_SIZE, dtype=torch.uint8)
            s.engine(i).read(donor, addr, 1, out=out).wait(10)
            assert np.array_equal(out, d), (i, addr)
        svc = s.stats()["nic"][str(donor)]["service"]
        # reads + writes all served, accounted per worker AND per client
        total = sum(w["served_wqes"] for w in svc["workers"].values())
        assert total == 192
        assert sum(c["ops"] for c in svc["clients"].values()) == 192
        assert sum(1 for w in svc["workers"].values()
                   if w["served_wqes"]) >= 2, svc["workers"]


# ---------------------------------------------------------------------------
# merging + ack coalescing (deterministic, via the dispatcher itself)
# ---------------------------------------------------------------------------

def _preload_jobs(donor_nic, descs, cq, src=0):
    """Queue donor jobs directly (the workers have not started yet), so
    the first dispatch sees the whole backlog as one DRR run."""
    jobs = [_DonorJob(desc=d, cq=cq, src_node=src, status=WCStatus.SUCCESS,
                      post_v=0.0, post_r=time.perf_counter(),
                      fwd_complete_v=0.0, fwd_delay_real=0.0)
            for d in descs]
    with donor_nic._serve_cv:
        q = donor_nic._serve_queues.setdefault(src, collections.deque())
        if src not in donor_nic._serve_deficit:
            donor_nic._serve_order.append(src)
            donor_nic._serve_deficit[src] = 0
        q.extend(jobs[:-1])
    donor_nic.serve_transfer(jobs[-1])      # starts workers, notifies
    return jobs


def _write_desc(dest, addr, data):
    req = WorkRequest(verb=Verb.WRITE, dest_node=dest, remote_addr=addr,
                      payload=data)
    return TransferDescriptor(verb=Verb.WRITE, dest_node=dest,
                              remote_addr=addr, num_pages=1, requests=[req])


def test_merged_run_coalesces_acks_and_isolates_page_errors():
    """A backlogged client's queue drains as ONE merged run with ONE
    coalesced ack; a job targeting pages outside the region fails alone
    (REMOTE_ERR) while its run-mates' bytes land intact."""
    with Fabric(device="cpu", scale=2e-8) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)                     # client node (ack routing)
        cq = CompletionQueue(cq_id=999)
        datas = {0: page(1), 2: page(2), 4: page(3), 6: page(4)}
        descs = [_write_desc(1, addr, d) for addr, d in datas.items()]
        descs.insert(2, _write_desc(1, 4096, page(9)))   # out of range
        _preload_jobs(donor, descs, cq)
        wcs = []
        deadline = time.perf_counter() + 5
        while len(wcs) < 5 and time.perf_counter() < deadline:
            wcs.extend(cq.poll(16))
            time.sleep(0.001)
        assert len(wcs) == 5, f"only {len(wcs)} completions arrived"
        by_status = collections.Counter(wc.status for wc in wcs)
        assert by_status[WCStatus.SUCCESS] == 4
        assert by_status[WCStatus.REMOTE_ERR] == 1
        bad = next(wc for wc in wcs if wc.status is WCStatus.REMOTE_ERR)
        assert bad.requests[0].remote_addr == 4096
        region = fab.directory.lookup(1)
        for addr, d in datas.items():       # run-mates landed intact
            assert np.array_equal(region.read(addr, 1).ravel(), d), addr
        svc = donor.service_snapshot()
        assert svc["merged_runs"] == 1 and svc["merged_jobs"] == 5
        assert svc["coalesced_acks"] == 1 and svc["coalesced_jobs"] == 5
        assert donor.stats.acks_sent.value == 1      # ONE ack on the wire
        assert fab.link(1, 0).ctrl_transfers.value == 1


def _read_desc(dest, addr, num_pages=1):
    req = WorkRequest(verb=Verb.READ, dest_node=dest, remote_addr=addr,
                      num_pages=num_pages)
    return TransferDescriptor(verb=Verb.READ, dest_node=dest,
                              remote_addr=addr, num_pages=num_pages,
                              requests=[req])


def test_merge_disabled_keeps_byte_fair_drr():
    """With merging off, per-job runs must still grant each client a
    deficit's worth of BYTES per rotation — the pointer stays on a client
    with unspent deficit instead of degrading to job-fair round-robin
    (which would hand a 16-page-WQE client 16x the bytes)."""
    from repro_torch.core.nic import ServiceConfig as SC
    with Fabric(device="cpu", scale=2e-8, service=SC(merge=False)) as fab:
        donor = fab.add_node(1, donor_pages=256)
        cq = CompletionQueue(cq_id=993)

        def mk(src, addr, num_pages):
            data = torch.zeros(num_pages * PAGE_SIZE, dtype=torch.uint8)
            req = WorkRequest(verb=Verb.WRITE, dest_node=1,
                              remote_addr=addr, num_pages=num_pages,
                              payload=data)
            desc = TransferDescriptor(verb=Verb.WRITE, dest_node=1,
                                      remote_addr=addr,
                                      num_pages=num_pages, requests=[req])
            return _DonorJob(desc=desc, cq=cq, src_node=src,
                             status=WCStatus.SUCCESS, post_v=0.0,
                             post_r=0.0, fwd_complete_v=0.0,
                             fwd_delay_real=0.0)

        with donor._serve_cv:       # drive the dispatcher directly
            for src in (0, 2):
                donor._serve_queues[src] = collections.deque()
                donor._serve_order.append(src)
                donor._serve_deficit[src] = 0
            for j in range(16):     # client 0: 16 single-page jobs
                donor._serve_queues[0].append(mk(0, j, 1))
            for j in range(4):      # client 2: 4 sixteen-page jobs
                donor._serve_queues[2].append(mk(2, 64 + 16 * j, 16))
        order = []
        while True:
            with donor._serve_cv:
                run = donor._next_run_locked(0)
                if run:
                    donor._serve_busy.discard(run[0].src_node)
            if not run:
                break
            order.append(run[0].src_node)
        # one full 16-job (= one quantum) burst of client 0 per rotation,
        # not 1 job alternating with 16x-bigger jobs
        assert order == [0] * 16 + [2] * 4, order


def test_merged_run_fallback_never_reexecutes_applied_segments():
    """[READ p, WRITE p, WRITE bad] in one run: the bad job must not make
    the fallback re-run the READ after the WRITE already landed — the
    read was ordered first and must surface the pre-write bytes."""
    with Fabric(device="cpu", scale=2e-8) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        region = fab.directory.lookup(1)
        old, new = page(50), page(51)
        region.write(5, old)
        cq = CompletionQueue(cq_id=992)
        descs = [_read_desc(1, 5), _write_desc(1, 5, new),
                 _write_desc(1, 4096, page(52))]      # out of range
        _preload_jobs(donor, descs, cq)
        wcs = []
        deadline = time.perf_counter() + 5
        while len(wcs) < 3 and time.perf_counter() < deadline:
            wcs.extend(cq.poll(8))
            time.sleep(0.001)
        assert len(wcs) == 3
        rd = next(wc for wc in wcs if wc.verb is Verb.READ)
        assert rd.status is WCStatus.SUCCESS
        assert np.array_equal(rd.requests[0].payload.ravel(), old), \
            "read ordered before the write observed post-write bytes"
        assert np.array_equal(region.read(5, 1).ravel(), new)
        statuses = collections.Counter(wc.status for wc in wcs)
        assert statuses[WCStatus.REMOTE_ERR] == 1


def test_same_client_jobs_service_in_arrival_order():
    """At most one run per client is in flight: back-to-back writes of
    the SAME page from one client land in arrival order even with 4
    workers idle — parallel workers must not reorder a client's jobs."""
    with Fabric(device="cpu", scale=2e-8,
                service=ServiceConfig(merge=False)) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        cq = CompletionQueue(cq_id=995)
        versions = [page(40 + v) for v in range(8)]
        # merge=False: each write is its own run; the in-flight guard must
        # still serialize them because they belong to one client
        descs = [_write_desc(1, 0, v) for v in versions]
        _preload_jobs(donor, descs, cq)
        deadline = time.perf_counter() + 5
        while cq.posted.value < len(versions) and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        assert cq.posted.value == len(versions)
        region = fab.directory.lookup(1)
        assert np.array_equal(region.read(0, 1).ravel(), versions[-1]), \
            "same-page writes from one client were reordered"


def test_jumbo_wqe_banks_deficit_and_gets_served():
    """A descriptor bigger than the DRR quantum banks deficit across
    dispatch passes and is eventually served — with no competing traffic
    the banking must progress without waiting on other runs."""
    with Fabric(device="cpu", scale=2e-8) as fab:
        fab.add_node(1, donor_pages=256)
        bx = RDMABox(0, fabric=fab, config=FAST)
        try:
            data = torch.cat([page(70 + i) for i in range(32)])
            bx.write(1, 0, data, num_pages=32).wait(10)   # 128KiB > 64KiB
            out = torch.zeros(32 * PAGE_SIZE, dtype=torch.uint8)
            bx.read(1, 0, 32, out=out).wait(10)
            assert np.array_equal(out, data)
        finally:
            bx.close()


def test_coalescing_can_be_disabled_by_policy():
    with Fabric(device="cpu", scale=2e-8,
                service=ServiceConfig(coalesce_acks=False)) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        cq = CompletionQueue(cq_id=998)
        descs = [_write_desc(1, 2 * i, page(i)) for i in range(6)]
        _preload_jobs(donor, descs, cq)
        deadline = time.perf_counter() + 5
        while cq.posted.value < 6 and time.perf_counter() < deadline:
            time.sleep(0.001)
        assert cq.posted.value == 6
        svc = donor.service_snapshot()
        assert svc["merged_runs"] == 1          # merging still on ...
        assert svc["coalesced_acks"] == 0       # ... coalescing off
        assert donor.stats.acks_sent.value == 6  # per-job acks


# ---------------------------------------------------------------------------
# close() during parallel service
# ---------------------------------------------------------------------------

def test_close_during_parallel_service_fails_not_drops():
    """Closing a donor NIC mid-service fails every queued job with an
    error completion — no client future is left hanging."""
    with Fabric(device="cpu", scale=2e-8) as fab:
        fab.add_node(1, donor_pages=256)
        bx = RDMABox(0, fabric=fab, config=FAST)
        region = fab.directory.lookup(1)
        donor = fab.nic(1)
        closer = None
        try:
            # hold every region stripe: service workers block mid-run, so
            # a backlog builds behind them
            for lk in region._locks:
                lk.acquire()
            futs = [bx.write(1, 2 * i, page(i)) for i in range(32)]
            deadline = time.perf_counter() + 5
            while time.perf_counter() < deadline and \
                    not any(donor._serve_queues.values()):
                time.sleep(0.002)
            assert any(donor._serve_queues.values()), "no backlog built"
            closer = threading.Thread(target=donor.close)
            closer.start()
            time.sleep(0.1)
        finally:
            for lk in region._locks:
                lk.release()
        closer.join(20)
        statuses = []
        for f in futs:                      # every future resolves — the
            err = f.exception(timeout=10)   # criterion is fail, not drop
            statuses.append(err.status if err is not None
                            else WCStatus.SUCCESS)
        assert WCStatus.RETRY_EXC_ERR in statuses, statuses
        bx.close()


def test_close_with_workers_never_started_still_fails_queued_jobs():
    """Jobs that reach a NIC whose service workers never spawned (or
    died) are failed by close() itself — the last-resort drain."""
    with Fabric(device="cpu", scale=2e-8) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        cq = CompletionQueue(cq_id=997)
        desc = _write_desc(1, 0, page(5))
        job = _DonorJob(desc=desc, cq=cq, src_node=0,
                        status=WCStatus.SUCCESS, post_v=0.0,
                        post_r=time.perf_counter(), fwd_complete_v=0.0,
                        fwd_delay_real=0.0)
        with donor._serve_cv:               # queue without starting workers
            donor._serve_queues.setdefault(0, collections.deque()).append(job)
            donor._serve_order.append(0)
            donor._serve_deficit[0] = 0
        donor.close()
        wcs = cq.poll(4)
        assert len(wcs) == 1
        assert wcs[0].status is WCStatus.RETRY_EXC_ERR


def test_closed_nic_fails_handoff_immediately():
    with Fabric(device="cpu", scale=2e-8) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        donor.close()
        cq = CompletionQueue(cq_id=996)
        desc = _write_desc(1, 0, page(6))
        donor.serve_transfer(_DonorJob(
            desc=desc, cq=cq, src_node=0, status=WCStatus.SUCCESS,
            post_v=0.0, post_r=time.perf_counter(), fwd_complete_v=0.0,
            fwd_delay_real=0.0))
        wcs = cq.poll(4)
        assert len(wcs) == 1 and wcs[0].status is WCStatus.RETRY_EXC_ERR


# ---------------------------------------------------------------------------
# stats tree exposure
# ---------------------------------------------------------------------------

def test_service_namespace_in_session_stats_tree():
    spec = box.ClusterSpec(num_donors=2, donor_pages=512, replication=1,
                           nic_scale=2e-8, serve_workers=2)
    with box.open(spec, device="cpu") as s:
        eng = s.engine()
        futs = [eng.write(s.donors[0], 2 * i, page(i)) for i in range(12)]
        for f in futs:
            f.wait(10)
        donor = s.donors[0]
        svc = s.stats()["nic"][str(donor)]["service"]
        assert svc["serve_workers"] == 2
        assert set(svc["workers"]) == {"0", "1"}
        for key in ("rounds", "merged_runs", "merged_jobs",
                    "coalesced_acks", "coalesced_jobs"):
            assert isinstance(svc[key], int), key
        assert sum(w["served_wqes"] for w in svc["workers"].values()) == 12
        assert svc["clients"][0]["ops"] == 12
        flat = s.stats(flat=True)
        assert f"nic.{donor}.service.serve_workers" in flat
        assert any(k.startswith(f"nic.{donor}.service.workers.")
                   for k in flat)



# ===========================================================================
# twins of tests/test_hot_cache.py
# ===========================================================================

# white-box donor-queue helpers shared with the service-plane tests
# (imported lazily inside the tests that need them: the tests directory
# is not a package, so the module is only importable once pytest has
# put it on sys.path)


def _service_helpers():
    # the donor-service twins above define them in this module
    return _preload_jobs, _read_desc, _write_desc


# ---------------------------------------------------------------------------
# spec / policy plumbing
# ---------------------------------------------------------------------------

def test_donor_cache_pages_roundtrips_through_spec():
    spec = box.ClusterSpec(donor_cache_pages=128,
                           cache={"name": "freq-clock",
                                  "params": {"promote_after": 3}})
    again = box.ClusterSpec.from_json(spec.to_json())
    assert again == spec
    assert again.donor_cache_pages == 128
    assert again.cache.params["promote_after"] == 3
    assert box.ClusterSpec().donor_cache_pages is None   # default: policy's


def test_donor_cache_pages_validation():
    box.ClusterSpec(donor_pages=256, donor_cache_pages=0).validate()
    box.ClusterSpec(donor_pages=256, donor_cache_pages=255).validate()
    with pytest.raises(ValueError, match="donor_cache_pages"):
        box.ClusterSpec(donor_pages=256, donor_cache_pages=256).validate()
    with pytest.raises(ValueError, match="donor_cache_pages"):
        box.ClusterSpec(donor_pages=256, donor_cache_pages=-1).validate()


def test_spec_knob_reaches_the_region_cache_tier():
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, donor_cache_pages=16,
                           cache={"name": "freq-clock",
                                  "params": {"promote_after": 1}})
    with box.open(spec, device="cpu") as s:
        tier = s.directory.lookup(s.donors[0]).cache
        assert isinstance(tier, CacheTier)
        assert tier.capacity == 16 and tier.promote_after == 1
    # the default spec leaves donors tierless (capacity 0 = disabled)
    with box.open(box.ClusterSpec(num_donors=1, donor_pages=256,
                                  replication=1, nic_scale=2e-8), device="cpu") as s:
        assert s.directory.lookup(s.donors[0]).cache is None


def test_cache_override_rejects_non_cacheconfig_policy():
    """A custom (non-CacheConfig) cache policy with donor_cache_pages set
    must fail loudly, not silently ignore the knob."""
    from repro_torch.box.policies import register_policy

    class NotACacheConfig:
        def build(self, region):
            return None

    register_policy("cache", "custom-cache-for-test")(NotACacheConfig)
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, donor_cache_pages=8,
                           cache="custom-cache-for-test")
    with pytest.raises(ValueError, match="donor_cache_pages=8 only applies"):
        box.open(spec, device="cpu")


def test_cache_config_build_disabled_and_clamped():
    region = RemoteRegion(0, 4)
    assert CacheConfig().build(region) is None
    assert CacheConfig(capacity_pages=0).build(region) is None
    tier = CacheConfig(capacity_pages=64).build(region)
    assert tier.capacity == 4            # clamped to the region


# ---------------------------------------------------------------------------
# promotion / CLOCK eviction (deterministic, unit level)
# ---------------------------------------------------------------------------

def _read_flags(tier, page_id, n=1):
    out = torch.empty((n, PAGE_SIZE), dtype=torch.uint8)
    flags, promote = tier.begin_reads([(page_id, n, out)])
    for p in promote:
        tier.promote(p)
    return flags[0]


def test_promotion_threshold_and_hits():
    region = RemoteRegion(0, 16)
    datas = {p: page(p) for p in range(4)}
    for p, d in datas.items():
        region.write(p, d)
    tier = CacheTier(region, capacity_pages=4, promote_after=2)
    assert _read_flags(tier, 0) is False     # miss 1: credit
    assert _read_flags(tier, 0) is False     # miss 2: promoted after
    assert _read_flags(tier, 0) is True      # hit, from the mirror
    out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
    assert tier.read_into(0, 1, out)
    assert np.array_equal(out, datas[0])
    snap = tier.snapshot()
    assert snap["promotions"] == 1 and snap["resident_pages"] == 1
    assert snap["hits"] == 1 and snap["misses"] == 2
    assert snap["hit_rate"] == pytest.approx(1 / 3)


def test_clock_eviction_gives_second_chance():
    region = RemoteRegion(0, 16)
    for p in range(5):
        region.write(p, page(p))
    tier = CacheTier(region, capacity_pages=2, promote_after=1)
    tier.promote(0)                          # free-list: frame 1
    tier.promote(1)                          # free-list: frame 0
    # hand over the REFERENCED frame: CLOCK must clear its bit and pass
    # over (second chance), reclaiming the unreferenced frame instead
    frame0 = tier._frame_of[0]
    tier._ref = [False, False]
    tier._ref[frame0] = True
    tier._hand = frame0
    tier.promote(2)
    assert set(tier._frame_of) == {0, 2}     # page 1 evicted, 0 spared
    assert tier.snapshot()["evictions"] == 1
    # that sweep spent page 0's grace: with no new reference it goes next
    tier._ref[tier._frame_of[2]] = False     # isolate page 0's fate
    tier.promote(3)
    assert 0 not in tier._frame_of
    assert set(tier._frame_of) == {2, 3}


def test_partial_residency_is_a_miss_and_out_of_range_is_untracked():
    region = RemoteRegion(0, 16)
    for p in range(4):
        region.write(p, page(p))
    tier = CacheTier(region, capacity_pages=4, promote_after=1)
    tier.promote(0)
    out = torch.empty((2, PAGE_SIZE), dtype=torch.uint8)
    flags, promote = tier.begin_reads([(0, 2, out)])
    assert flags == [False]                  # page 1 not resident
    assert promote == [1]                    # only the uncached page earns
    flags, _ = tier.begin_reads([(100, 2, out)])
    assert flags == [False]                  # out of range: plain miss,
    assert 100 not in tier._pending          # never tracked or promoted
    tier.promote(100)                        # bounds-guarded no-op
    assert 100 not in tier._frame_of


def test_read_into_reports_eviction_race():
    region = RemoteRegion(0, 16)
    region.write(0, page(0))
    tier = CacheTier(region, capacity_pages=2, promote_after=1)
    out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
    assert tier.read_into(0, 1, out) is False    # never promoted


# ---------------------------------------------------------------------------
# coherence: the tier can never serve stale bytes
# ---------------------------------------------------------------------------

def test_write_through_updates_the_mirror():
    region = RemoteRegion(0, 16)
    old, new = page(1), page(2)
    region.write(3, old)
    tier = region.cache = CacheTier(region, capacity_pages=4,
                                    promote_after=1)
    tier.promote(3)
    region.write(3, new)                     # scalar write path
    out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
    assert tier.read_into(3, 1, out)
    assert np.array_equal(out, new)
    newer = page(3)
    region.writev([(3, newer)])              # vectorized write path
    assert tier.read_into(3, 1, out)
    assert np.array_equal(out, newer)
    assert tier.snapshot()["write_throughs"] == 2


def test_uncached_write_invalidates_pending_credit():
    region = RemoteRegion(0, 16)
    region.write(5, page(5))
    tier = region.cache = CacheTier(region, capacity_pages=4,
                                    promote_after=2)
    assert _read_flags(tier, 5) is False     # credit 1 of 2
    region.write(5, page(6))                 # bytes the credit saw are gone
    snap = tier.snapshot()
    assert snap["invalidations"] == 1
    assert _read_flags(tier, 5) is False     # back to credit 1
    assert _read_flags(tier, 5) is False     # credit 2: promoted
    assert _read_flags(tier, 5) is True


def test_merged_run_mixing_cached_read_write_read_stays_coherent():
    """[READ p, WRITE p, READ p] in ONE merged run with p cached: the
    first read must surface pre-write bytes (it was ordered first), the
    second post-write bytes — a stale mirror would fail either side."""
    _preload_jobs, _read_desc, _write_desc = _service_helpers()
    with Fabric(device="cpu", scale=2e-8,
                cache=CacheConfig(capacity_pages=8, promote_after=1)) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        region = fab.directory.lookup(1)
        old, new = page(60), page(61)
        region.write(5, old)
        region.cache.promote(5)
        cq = CompletionQueue(cq_id=991)
        descs = [_read_desc(1, 5), _write_desc(1, 5, new), _read_desc(1, 5)]
        _preload_jobs(donor, descs, cq)
        wcs = []
        deadline = time.perf_counter() + 5
        while len(wcs) < 3 and time.perf_counter() < deadline:
            wcs.extend(cq.poll(8))
            time.sleep(0.001)
        assert len(wcs) == 3
        assert all(wc.status is WCStatus.SUCCESS for wc in wcs)
        by_req = {id(wc.requests[0]): wc for wc in wcs}
        first = by_req[id(descs[0].requests[0])].requests[0].payload.ravel()
        second = by_req[id(descs[2].requests[0])].requests[0].payload.ravel()
        assert np.array_equal(first, old), \
            "read ordered before the write observed post-write bytes"
        assert np.array_equal(second, new), \
            "read ordered after the write served STALE cached bytes"
        out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        assert region.cache.read_into(5, 1, out)     # mirror written through
        assert np.array_equal(out, new)
        snap = region.cache.snapshot()
        assert snap["write_throughs"] == 1 and snap["hits"] >= 1


def test_concurrent_mixed_hammer_reads_back_byte_exact():
    """Two clients hammer a tiny universe through a too-small tier
    (constant promotion/eviction churn) with per-batch write ordering;
    the final readback must be byte-exact for every page."""
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           num_clients=2, nic_scale=2e-8,
                           donor_cache_pages=8,
                           cache={"name": "freq-clock",
                                  "params": {"promote_after": 1}})
    ops, universe, batch = 96, 24, 16
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        share = spec.donor_pages // 2
        final = {}
        lock = threading.Lock()

        def client(i):
            eng = s.engine(i)
            base = i * share
            rng = np.random.default_rng(i)
            version = {}
            out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
            for lo in range(0, ops, batch):
                futs, wrote = [], set()
                for _ in range(batch):
                    p = base + int(rng.integers(universe))
                    if rng.random() < 0.4 and p not in wrote:
                        wrote.add(p)
                        v = version.get(p, 0) + 1
                        version[p] = v
                        fill = (i + 37 * p + 101 * v) % 256
                        futs.append(eng.write(
                            donor, p, full(PAGE_SIZE, fill)))
                    else:
                        futs.append(eng.read(donor, p, 1, out=out))
                for f in futs:
                    f.wait(30)
            with lock:
                final.update({p: (i + 37 * p + 101 * v) % 256
                              for p, v in version.items()})

        ts = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        buf = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        for p, fill in sorted(final.items()):
            s.engine(0 if p < share else 1).read(
                donor, p, 1, out=buf).wait(30)
            assert (buf == fill).all(), f"stale bytes on page {p}"
        cache = s.stats()["nic"][str(donor)]["service"]["cache"]
        assert cache["hits"] > 0, cache      # tier actually served traffic
        assert cache["evictions"] > 0, cache  # ... while churning


# ---------------------------------------------------------------------------
# stats exposure
# ---------------------------------------------------------------------------

def test_cache_namespace_in_session_stats_tree():
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, donor_cache_pages=8,
                           cache={"name": "freq-clock",
                                  "params": {"promote_after": 1}})
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        eng = s.engine()
        eng.write(donor, 3, page(3)).wait(10)
        for _ in range(3):
            out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
            eng.read(donor, 3, 1, out=out).wait(10)
        cache = s.stats()["nic"][str(donor)]["service"]["cache"]
        assert cache["capacity_pages"] == 8
        assert cache["hits"] >= 2 and cache["promotions"] == 1
        assert 0.0 < cache["hit_rate"] < 1.0
        flat = s.stats(flat=True)
        for leaf in ("hits", "misses", "promotions", "evictions",
                     "invalidations", "hit_rate"):
            assert f"nic.{donor}.service.cache.{leaf}" in flat, leaf
        # a tierless NIC (the client) reports the zeroed shape
        client = s.clients[0]
        assert flat[f"nic.{client}.service.cache.capacity_pages"] == 0
        assert flat[f"nic.{client}.service.cache.hit_rate"] == 0.0


# ---------------------------------------------------------------------------
# zipfian generator (benchmarks.common)
# ---------------------------------------------------------------------------

def test_zipfian_pages_is_deterministic_per_seed():
    a = zipfian_pages(256, 512, s=1.1, seed=7)
    b = zipfian_pages(256, 512, s=1.1, seed=7)
    c = zipfian_pages(256, 512, s=1.1, seed=8)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 256


def test_zipfian_top_pages_carry_expected_share():
    """Top-1% of pages (by empirical frequency) must carry the analytic
    zipf share of the traffic — the skew the cache exists to exploit."""
    n, ops, s = 1000, 50_000, 1.1
    w = zipfian_weights(n, s)
    assert w.sum() == pytest.approx(1.0)
    expected = float(w[: n // 100].sum())    # analytic top-1% share
    trace = zipfian_pages(n, ops, s=s, seed=3)
    counts = np.bincount(trace, minlength=n)
    top = np.sort(counts)[::-1][: n // 100].sum() / ops
    assert top == pytest.approx(expected, abs=0.03)
    assert top > 0.25                        # heavy-tailed, not uniform


def test_zipfian_working_set_tracks_coverage():
    ws50 = zipfian_working_set(512, s=1.1, coverage=0.5)
    ws90 = zipfian_working_set(512, s=1.1, coverage=0.9)
    assert 0 < ws50 < ws90 <= 512
    w = zipfian_weights(512, 1.1)
    assert w[:ws90].sum() >= 0.9 > w[: ws90 - 1].sum()


def test_merged_runs_still_isolate_errors_with_cache_enabled():
    """The fallback path (per-job re-execution after a bad run-mate)
    resets the bad run to all-miss accounting but must keep serving
    correct bytes from the region."""
    _preload_jobs, _read_desc, _write_desc = _service_helpers()
    with Fabric(device="cpu", scale=2e-8,
                cache=CacheConfig(capacity_pages=8, promote_after=1)) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        region = fab.directory.lookup(1)
        good = page(80)
        region.write(7, good)
        region.cache.promote(7)
        cq = CompletionQueue(cq_id=990)
        descs = [_read_desc(1, 7), _write_desc(1, 4096, page(81))]
        _preload_jobs(donor, descs, cq)
        wcs = []
        deadline = time.perf_counter() + 5
        while len(wcs) < 2 and time.perf_counter() < deadline:
            wcs.extend(cq.poll(8))
            time.sleep(0.001)
        assert len(wcs) == 2
        statuses = collections.Counter(wc.status for wc in wcs)
        assert statuses[WCStatus.SUCCESS] == 1
        assert statuses[WCStatus.REMOTE_ERR] == 1
        ok = next(wc for wc in wcs if wc.status is WCStatus.SUCCESS)
        assert np.array_equal(ok.requests[0].payload.ravel(), good)



# ===========================================================================
# twins of tests/test_slo.py
# ===========================================================================

SLO_FAST = dict(nic_scale=1e-7, window_bytes=1 << 20)
PAGE = tb(np.arange(PAGE_SIZE, dtype=np.uint8))


# ---- spec: round-trip + resolution ----------------------------------------
def test_sla_spec_round_trips_through_json():
    spec = box.ClusterSpec(
        num_clients=3, service="slo", admission="congestion",
        sla=["premium", "standard", "best_effort"],
        sla_classes={"premium": {"p99_target_us": 12_000.0}})
    assert box.ClusterSpec.from_json(spec.to_json()) == spec
    assert box.ClusterSpec.from_dict(spec.to_dict()) == spec
    classes = spec.sla_for_clients()
    assert [c.name for c in classes] == ["premium", "standard",
                                         "best_effort"]
    assert classes[0].p99_target_us == 12_000.0     # override applied
    assert classes[0].protected and classes[0].weight == 4.0
    assert classes[2].ecn_mark_fraction == 0.25


def test_single_sla_name_broadcasts_to_every_client():
    spec = box.ClusterSpec(num_clients=3, sla="standard")
    classes = spec.validate().sla_for_clients()
    assert len(classes) == 3
    assert all(c.name == "standard" and c.weight == 2.0 for c in classes)


def test_spec_defined_class_without_registration():
    spec = box.ClusterSpec(
        num_clients=1, sla="batch",
        sla_classes={"batch": {"weight": 0.5, "priority": -1,
                               "ecn_mark_fraction": 0.1}})
    cls = spec.validate().sla_for_clients()[0]
    assert isinstance(cls, box.SLAClass)
    assert (cls.weight, cls.priority, cls.ecn_mark_fraction) == \
        (0.5, -1, 0.1)


def test_unknown_class_and_bad_shapes_rejected():
    with pytest.raises(ValueError, match="unknown SLA class 'gold'"):
        box.ClusterSpec(num_clients=1, sla="gold").validate()
    with pytest.raises(ValueError, match="one class per client"):
        box.ClusterSpec(num_clients=3, sla=["premium"]).validate()
    with pytest.raises(ValueError, match="sla_classes given but sla"):
        box.ClusterSpec(sla_classes={"premium": {}}).validate()
    with pytest.raises(ValueError, match="weight must be > 0"):
        box.ClusterSpec(num_clients=1, sla="x",
                        sla_classes={"x": {"weight": 0.0}}).validate()
    with pytest.raises(ValueError, match="ecn_mark_fraction"):
        box.ClusterSpec(
            num_clients=1, sla="x",
            sla_classes={"x": {"ecn_mark_fraction": 0.0}}).validate()


# ---- the slo service policy ------------------------------------------------
def _queues(jobs):
    return {c: collections.deque(SimpleNamespace(post_v=v) for v in vs)
            for c, vs in jobs.items()}


def test_slo_quantum_scales_with_weight():
    svc = SLOServiceConfig(quantum_bytes=64 * PAGE_SIZE,
                           client_weight={1: 4.0, 2: 0.001})
    assert svc.quantum_for(1) == 256 * PAGE_SIZE
    assert svc.quantum_for(2) == PAGE_SIZE          # floored at one page
    assert svc.quantum_for(99) == 64 * PAGE_SIZE    # unlisted: weight 1


def test_slo_visit_order_priority_then_deadline_then_rotation():
    order = [10, 11, 12]
    # client 11 is premium (priority 2, tight deadline); 10 and 12 tie on
    # priority so the older head job (12) goes first
    svc = SLOServiceConfig(
        client_priority={11: 2},
        client_deadline_us={10: 1000.0, 11: 1000.0, 12: 1000.0})
    queues = _queues({10: [500.0], 11: [900.0], 12: [100.0]})
    visits = [order[p % 3] for p in svc.visit_offsets(order, 0, queues)]
    assert visits == [11, 12, 10]
    # without SLA maps the plan degenerates to plain rotation
    plain = SLOServiceConfig()
    assert plain.visit_offsets(order, 1, _queues({})) == \
        ServiceConfig().visit_offsets(order, 1, _queues({}))


def test_slo_visit_order_respects_rotation_start():
    order = [7, 8]
    svc = SLOServiceConfig()            # no classes: pure rotation
    assert [order[p % 2] for p in svc.visit_offsets(order, 1, _queues({}))] \
        == [8, 7]


# ---- SLO-protected admission ----------------------------------------------
def _wc(lat_us, marked=False):
    return WorkCompletion(wr_id=0, verb=Verb.WRITE, dest_node=1,
                          nbytes=PAGE_SIZE, status=WCStatus.SUCCESS,
                          post_vtime_us=0.0, complete_vtime_us=lat_us,
                          ecn_mult=3.0 if marked else 1.0)


def test_protected_hook_ignores_marks_until_own_p99_breaks():
    hook = CongestionAwareHook(adjust_every=4, calibration=4,
                               protected=True, p99_target_us=500.0)
    for _ in range(4):                  # calibration at healthy latency
        hook.observe(_wc(10.0))
    for _ in range(16):                 # every completion ECN-marked, but
        hook.observe(_wc(10.0, marked=True))    # own tail is fine
    assert hook.window_fraction == 1.0
    assert hook.snapshot()["protected"] is True
    for _ in range(64):                 # now the tail contract breaks
        hook.observe(_wc(2000.0, marked=True))
    assert hook.window_fraction < 1.0


def test_unprotected_hook_sheds_on_mark_fraction():
    sensitive = CongestionAwareHook(adjust_every=8, calibration=4,
                                    ecn_mark_fraction=0.25)
    lax = CongestionAwareHook(adjust_every=8, calibration=4,
                              ecn_mark_fraction=1.0)
    for hook in (sensitive, lax):
        for _ in range(4):
            hook.observe(_wc(10.0))
        for i in range(16):             # every 4th completion marked (25%)
            hook.observe(_wc(10.0, marked=(i % 4 == 0)))
    assert sensitive.window_fraction < 1.0      # 25% marks trip 0.25
    assert lax.window_fraction == 1.0           # but not 100%-threshold


# ---- end to end ------------------------------------------------------------
def test_session_wires_sla_into_service_admission_and_stats():
    spec = box.ClusterSpec(
        num_donors=1, donor_pages=2048, num_clients=2, replication=1,
        service="slo", admission="congestion",
        sla=["premium", "best_effort"], **SLO_FAST)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        for i in range(2):
            s.engine(i).write(donor, i, PAGE).wait(10)
        s.flush()
        stats = s.stats()
        per_class = stats["nic"][str(donor)]["service"]["per_class"]
        assert set(per_class) == {"premium", "best_effort"}
        for d in per_class.values():
            assert d["ops"] >= 1
            assert d["latency"]["count"] >= 1
            assert d["latency"]["p99_us"] > 0
        hook0 = stats["client"]["0"]["box"]["admission"]["hook"]
        assert hook0["protected"] is True
        assert hook0["p99_target_us"] == 5000.0
        hook1 = stats["client"]["1"]["box"]["admission"]["hook"]
        assert hook1["protected"] is False
        for i in range(2):
            lat = stats["client"][str(i)]["box"]["latency"]
            assert lat["count"] >= 1 and lat["p50_us"] > 0


def test_plain_drr_with_sla_still_attributes_classes():
    spec = box.ClusterSpec(
        num_donors=1, donor_pages=2048, num_clients=1, replication=1,
        service="drr", sla="standard", **SLO_FAST)
    with box.open(spec, device="cpu") as s:
        s.engine(0).write(s.donors[0], 0, PAGE).wait(10)
        s.flush()
        per_class = s.stats()["nic"][str(s.donors[0])]["service"][
            "per_class"]
        assert set(per_class) == {"standard"}


def test_registered_custom_sla_class_resolves_like_builtin():
    @box.register_policy("sla", "gold-test")
    def gold(**params):
        return box.SLAClass(name="gold-test", weight=8.0, priority=3,
                            **params)
    try:
        spec = box.ClusterSpec(num_clients=1, sla="gold-test",
                               sla_classes={"gold-test":
                                            {"p99_target_us": 750.0}})
        cls = spec.validate().sla_for_clients()[0]
        assert (cls.weight, cls.priority, cls.p99_target_us) == \
            (8.0, 3, 750.0)
    finally:
        from repro_torch.box.policies import _REGISTRIES
        _REGISTRIES["sla"].pop("gold-test", None)



# ===========================================================================
# twins of tests/test_mr_cache.py
# ===========================================================================

def _desc(verb, dest, addr, num_pages=1, payload=None):
    req = WorkRequest(verb=verb, dest_node=dest, remote_addr=addr,
                      num_pages=num_pages, payload=payload)
    return TransferDescriptor(verb=verb, dest_node=dest, remote_addr=addr,
                              num_pages=num_pages, requests=[req])


def _mr_stats(session, donor):
    return session.stats()["nic"][str(donor)]["service"]["mr"]


def _donor_registrations(session, donor):
    return session.stats()["nic"][str(donor)]["registrations"]


# ---------------------------------------------------------------------------
# spec / policy plumbing
# ---------------------------------------------------------------------------

def test_registered_pages_roundtrips_through_spec():
    spec = box.ClusterSpec(registered_pages=128,
                           mr={"name": "lru", "params": {}})
    again = box.ClusterSpec.from_json(spec.to_json())
    assert again == spec
    assert again.registered_pages == 128
    assert again.mr.name == "lru"
    assert box.ClusterSpec().registered_pages is None   # default: policy's


def test_registered_pages_validation():
    box.ClusterSpec(donor_pages=256, registered_pages=1).validate()
    box.ClusterSpec(donor_pages=256, registered_pages=256).validate()
    with pytest.raises(ValueError, match="registered_pages"):
        box.ClusterSpec(donor_pages=256, registered_pages=0).validate()
    with pytest.raises(ValueError, match="registered_pages"):
        box.ClusterSpec(donor_pages=256, registered_pages=-4).validate()
    with pytest.raises(ValueError, match="registered_pages"):
        box.ClusterSpec(donor_pages=256, registered_pages=257).validate()


def test_spec_knob_reaches_the_region_mr_cache():
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=16)
    with box.open(spec, device="cpu") as s:
        mr = s.directory.lookup(s.donors[0]).mr
        assert isinstance(mr, MRCache)
        assert mr.capacity == 16
    # the default spec leaves donors cacheless (capacity 0 = disabled:
    # every page pre-registered, the historical behavior)
    with box.open(box.ClusterSpec(num_donors=1, donor_pages=256,
                                  replication=1, nic_scale=2e-8), device="cpu") as s:
        assert s.directory.lookup(s.donors[0]).mr is None


def test_mr_override_rejects_non_mrconfig_policy():
    """A custom (non-MRConfig) mr policy with registered_pages set must
    fail loudly, not silently ignore the knob."""
    from repro_torch.box.policies import register_policy

    class NotAnMRConfig:
        def build(self, region):
            return None

    register_policy("mr", "custom-mr-for-test")(NotAnMRConfig)
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=8,
                           mr="custom-mr-for-test")
    with pytest.raises(ValueError, match="registered_pages=8 only applies"):
        box.open(spec, device="cpu")


def test_custom_mr_policy_via_registry():
    """The mr kind is @register_policy-extensible like cache/service."""
    from repro_torch.box.policies import create_policy, register_policy
    from repro_torch.box.spec import PolicySpec

    @register_policy("mr", "half-region-for-test")
    class HalfRegion(MRConfig):
        def build(self, region):
            return MRCache(region, max(1, region.num_pages // 2))

    cfg = create_policy("mr", PolicySpec("half-region-for-test"))
    mr = cfg.build(RemoteRegion(1, 64))
    assert isinstance(mr, MRCache) and mr.capacity == 32


def test_mr_config_build_disabled_and_clamped():
    region = RemoteRegion(0, 4)
    assert MRConfig().build(region) is None
    assert MRConfig(capacity_pages=0).build(region) is None
    mr = MRConfig(capacity_pages=64).build(region)
    assert mr.capacity == 4              # clamped to the region


# ---------------------------------------------------------------------------
# fault → register → replay (end to end)
# ---------------------------------------------------------------------------

def test_first_touch_fault_register_replay():
    """An unregistered extent soft-fails RNR-style, registers, and the
    client's existing retry machinery replays it — transparently to the
    caller, with every step visible in the stats."""
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=8)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        eng = s.engine(0)
        data = page(7)
        eng.write(donor, 3, data).wait(30)          # first touch: faults
        out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        eng.read(donor, 3, 1, out=out).wait(30)     # warm: hits
        assert (out == data).all()
        st = _mr_stats(s, donor)
        assert st["capacity_pages"] == 8
        assert st["faults"] >= 1
        assert st["replays"] == st["faults"]        # every fault replayed
        assert st["registrations"] == 1             # page 3, once
        assert st["resident_pages"] == 1
        assert st["pinned_pages"] == 0              # replay unpinned it
        assert st["hits"] >= 2                      # replayed write + read
        assert 0.0 < st["hit_rate"] < 1.0
        assert _donor_registrations(s, donor) == st["faults"]
        # the replay rode the client's bounded RNR machinery
        assert s.stats()["client"]["0"]["box"]["rnr_retries"] >= 1


def test_warm_extent_registers_exactly_once():
    """N accesses to one extent pay registration once — the perf claim:
    a hit costs zero registration."""
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=32)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        eng = s.engine(0)
        eng.write(donor, 5, page(1)).wait(30)
        regs = _mr_stats(s, donor)["registrations"]
        out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        for _ in range(10):
            eng.read(donor, 5, 1, out=out).wait(30)
        st = _mr_stats(s, donor)
        assert st["registrations"] == regs          # flat while warm
        assert st["faults"] == st["replays"]
        assert _donor_registrations(s, donor) == st["faults"]


@pytest.mark.parametrize("kernel_space", [True, False])
def test_auto_crossover_never_charges_warm_extent(kernel_space):
    """RegMode.AUTO interplay (satellite): whatever the client-side
    crossover resolves a posting to (preMR memcpy below, dynMR
    registration above — kernel space always dynMR), the DONOR-side MR
    cache is orthogonal: a warm extent never pays reg_cost_us again.
    Cost overrides put the user-space crossover at 2 pages, so the
    1-page and 4-page transfers here bracket it."""
    cost = {"memcpy_us_per_page": 1.0, "reg_user_base_us": 0.9,
            "reg_user_per_page_us": 0.1}
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=64,
                           reg_mode="auto", kernel_space=kernel_space,
                           nic_cost=cost)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        eng = s.engine(0)
        small = page(11)
        big = torch.cat([page(12 + k) for k in range(4)])
        eng.write(donor, 0, small).wait(30)         # below crossover
        eng.write(donor, 8, big).wait(30)           # above crossover
        st = _mr_stats(s, donor)
        donor_regs = _donor_registrations(s, donor)
        assert st["registrations"] == 5             # pages 0 + 8..11, once
        out1 = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        out4 = torch.empty(4 * PAGE_SIZE, dtype=torch.uint8)
        for _ in range(5):
            eng.read(donor, 0, 1, out=out1).wait(30)
            eng.read(donor, 8, 4, out=out4).wait(30)
        assert (out1 == small).all()
        assert (out4 == big).all()
        warm = _mr_stats(s, donor)
        assert warm["registrations"] == st["registrations"]
        assert _donor_registrations(s, donor) == donor_regs
        assert warm["faults"] == st["faults"]


def test_rnr_retry_limit_zero_surfaces_the_fault():
    """With the retry budget at zero the fault is not replayed — it
    surfaces as a transient TransferError (no new retry plumbing: the MR
    cache rides the machinery, including its off switch)."""
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=8,
                           rnr_retry_limit=0)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        eng = s.engine(0)
        with pytest.raises(TransferError) as ei:
            eng.write(donor, 3, page(1)).wait(30)
        assert ei.value.status is WCStatus.RNR_RETRY_ERR
        assert ei.value.transient


def test_out_of_range_is_remote_err_not_a_fault_loop():
    """An extent outside the region is a permanent error: the cache
    passes (registering unreachable pages — or replaying a permanent
    error — would be wrong twice over)."""
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=8)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        eng = s.engine(0)
        with pytest.raises(TransferError) as ei:
            eng.write(donor, 10_000, page(1)).wait(30)
        assert ei.value.status is WCStatus.REMOTE_ERR
        st = _mr_stats(s, donor)
        assert st["faults"] == 0 and st["registrations"] == 0


def test_disabled_path_is_untouched():
    """Without the knob the serve path never consults an MR cache: no
    donor-side registrations, zeroed ``service.mr.*`` shape — today's
    charges, bit for bit."""
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        eng = s.engine(0)
        out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        for p in range(8):
            eng.write(donor, p, page(p)).wait(30)
            eng.read(donor, p, 1, out=out).wait(30)
        assert _donor_registrations(s, donor) == 0
        assert _mr_stats(s, donor) == MRCache.disabled_snapshot()
        assert s.stats()["client"]["0"]["box"]["rnr_retries"] == 0


# ---------------------------------------------------------------------------
# LRU eviction / pinning (deterministic, unit level)
# ---------------------------------------------------------------------------

def test_lru_evicts_coldest_and_deregisters():
    mr = MRCache(RemoteRegion(1, 64), capacity_pages=4)
    for p in range(4):
        assert _fault_then_replay(mr, p) == 1
    # touch page 0 so page 1 is coldest, then overflow
    assert mr.serve(_desc(Verb.READ, 1, 0))[0] is False
    _fault_then_replay(mr, 4)
    snap = mr.snapshot()
    assert snap["resident_pages"] == 4
    assert snap["deregistrations"] == 1
    assert not mr.serve(_desc(Verb.READ, 1, 0))[0]      # still warm
    assert mr.serve(_desc(Verb.READ, 1, 1))[0]          # 1 was evicted


def test_all_pinned_overflows_transiently_instead_of_livelocking():
    mr = MRCache(RemoteRegion(1, 64), capacity_pages=1)
    da, db = _desc(Verb.READ, 1, 0), _desc(Verb.READ, 1, 1)
    assert mr.serve(da) == (True, 1)
    assert mr.serve(db) == (True, 1)        # victim pinned: overflow
    assert mr.snapshot()["resident_pages"] == 2
    assert mr.serve(da) == (False, 0)
    assert mr.serve(db) == (False, 0)
    _fault_then_replay(mr, 2)               # next fault sweeps the excess
    snap = mr.snapshot()
    assert snap["resident_pages"] == 1
    assert snap["deregistrations"] == 2


def test_racing_faults_of_one_extent_register_once():
    """The fault path re-checks residency after taking region stripes →
    mr lock (the CacheTier lock-order invariant): a racing fault of the
    same extent downgrades to a hit instead of double-registering."""
    mr = MRCache(RemoteRegion(1, 64), capacity_pages=8)
    results = []
    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait()
        results.append(mr.serve(_desc(Verb.READ, 1, 3)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(reg for _, reg in results) == 1      # page 3 registered once
    assert mr.snapshot()["registrations"] == 1


def test_merged_descriptor_faults_and_pins_per_request():
    """A merged (multi-request) descriptor faults as one job but pins
    per wr_id, so whatever shape the replay re-merges into still hits
    and unpins completely."""
    reqs = [WorkRequest(verb=Verb.READ, dest_node=1, remote_addr=p,
                        num_pages=2) for p in (0, 2, 4)]
    merged = TransferDescriptor(verb=Verb.READ, dest_node=1, remote_addr=0,
                                num_pages=6, requests=reqs)
    mr = MRCache(RemoteRegion(1, 64), capacity_pages=8)
    assert mr.serve(merged) == (True, 6)
    assert mr.snapshot()["pinned_pages"] == 6
    # the replay arrives split into solo descriptors (same wr_ids)
    for r in reqs:
        solo = TransferDescriptor(verb=Verb.READ, dest_node=1,
                                  remote_addr=r.remote_addr, num_pages=2,
                                  requests=[r])
        assert mr.serve(solo) == (False, 0)
    snap = mr.snapshot()
    assert snap["pinned_pages"] == 0
    assert snap["replays"] == 3


# ---------------------------------------------------------------------------
# registration churn under concurrency (byte-exactness)
# ---------------------------------------------------------------------------

def test_churn_hammer_stays_byte_exact():
    """Two clients hammer a donor whose MR cache is far smaller than the
    touched page set: constant fault/evict/re-register churn must never
    corrupt or lose bytes, and residency must end bounded."""
    clients, universe, ops = 2, 48, 96
    spec = box.ClusterSpec(num_donors=1, donor_pages=256,
                           num_clients=clients, replication=1,
                           nic_scale=2e-8, registered_pages=8,
                           rnr_backoff_us=10.0)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        share = spec.donor_pages // clients
        errs = []

        def client(i):
            try:
                eng = s.engine(i)
                rng = np.random.default_rng(i)
                base = i * share
                version = {}
                for lo in range(0, ops, 16):
                    futs, wrote = [], set()
                    for _ in range(16):
                        p = base + int(rng.integers(0, universe))
                        if rng.random() < 0.5 and p not in wrote:
                            wrote.add(p)
                            v = version.get(p, 0) + 1
                            version[p] = v
                            data = full(PAGE_SIZE,
                                           (i + 37 * p + 101 * v) % 256)
                            futs.append(eng.write(donor, p, data))
                        else:
                            out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
                            futs.append(eng.read(donor, p, 1, out=out))
                    for f in futs:
                        f.wait(60)
                buf = torch.empty(PAGE_SIZE, dtype=torch.uint8)
                for p, v in version.items():
                    eng.read(donor, p, 1, out=buf).wait(60)
                    want = (i + 37 * p + 101 * v) % 256
                    assert (buf == want).all(), \
                        f"client {i} page {p}: want {want}"
            except Exception as e:      # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        st = _mr_stats(s, donor)
        assert st["deregistrations"] > 0            # churn actually happened
        assert st["faults"] > 8
        # a replayed request can re-merge with a FRESH miss and fault
        # again, so replays <= faults; but every fault was eventually
        # served (all futures resolved), so nothing stayed pinned
        assert 0 < st["replays"] <= st["faults"]
        assert st["pinned_pages"] == 0
        # residency is bounded by capacity + concurrently-pinned faults
        # (2 clients x 16 in-flight); it can exceed capacity only while
        # every resident page is pinned (transient overflow)
        assert st["resident_pages"] <= st["capacity_pages"] + 32


def test_evict_between_classify_and_serve_is_byte_exact():
    """White-box evict-while-serving race: deregistering an extent after
    bytes were written does not lose them — the region owns the bytes,
    the MR cache only gates access, so a re-registered read returns
    exactly what was written."""
    with Fabric(device="cpu", scale=2e-8) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        region = fab.directory.lookup(1)
        region.mr = mr = MRCache(region, capacity_pages=4)
        cq = CompletionQueue(cq_id=991)
        data = page(5)
        jobs = _preload(donor, [_desc(Verb.WRITE, 1, 2, payload=data)], cq)
        wcs = _drain(cq, 1)
        assert wcs[0].status is WCStatus.RNR_RETRY_ERR  # first touch
        # replay the job by hand (no client engine attached): must hit
        _preload(donor, [jobs[0].desc], cq)
        assert _drain(cq, 1)[0].status is WCStatus.SUCCESS
        # adversarial eviction between serves: dereg everything
        with mr._lock:
            mr._lru.clear()
        out_desc = _desc(Verb.READ, 1, 2)
        _preload(donor, [out_desc], cq)
        assert _drain(cq, 1)[0].status is WCStatus.RNR_RETRY_ERR
        _preload(donor, [out_desc], cq)             # replay re-registers
        assert _drain(cq, 1)[0].status is WCStatus.SUCCESS
        assert (out_desc.requests[0].payload.reshape(-1) == data).all()


def _preload(donor_nic, descs, cq, src=0):
    from repro_torch.core.nic import _DonorJob
    jobs = [_DonorJob(desc=d, cq=cq, src_node=src, status=WCStatus.SUCCESS,
                      post_v=0.0, post_r=time.perf_counter(),
                      fwd_complete_v=0.0, fwd_delay_real=0.0)
            for d in descs]
    for j in jobs:
        donor_nic.serve_transfer(j)
    return jobs


def _drain(cq, n, timeout=5.0):
    wcs = []
    deadline = time.perf_counter() + timeout
    while len(wcs) < n and time.perf_counter() < deadline:
        wcs.extend(cq.poll(16))
        time.sleep(0.001)
    assert len(wcs) == n, f"only {len(wcs)}/{n} completions arrived"
    return wcs


# ---------------------------------------------------------------------------
# StagingPool hardening (satellite)
# ---------------------------------------------------------------------------

def test_staging_pool_acquire_timeout_raises_boxerror():
    pool = StagingPool(slab_pages=1, num_slabs=1)
    held = pool.acquire(torch.zeros(PAGE_SIZE, dtype=torch.uint8))
    t0 = time.monotonic()
    with pytest.raises(BoxError, match="timed out"):
        pool.acquire(torch.zeros(PAGE_SIZE, dtype=torch.uint8), timeout=0.05)
    assert time.monotonic() - t0 < 2.0
    pool.release(held)
    pool.acquire(torch.zeros(PAGE_SIZE, dtype=torch.uint8), timeout=0.05)  # now free


def test_staging_pool_counters_and_snapshot():
    pool = StagingPool(slab_pages=1, num_slabs=2)
    payload = torch.zeros(PAGE_SIZE, dtype=torch.uint8)
    a = pool.acquire(payload)
    b = pool.acquire(payload)
    assert pool.snapshot() == {"slabs": 2, "slab_pages": 1, "free": 0,
                               "acquires": 2, "waits": 0}
    released = []

    def releaser():
        time.sleep(0.05)
        released.append(True)
        pool.release(a)

    t = threading.Thread(target=releaser)
    t.start()
    c = pool.acquire(payload, timeout=5.0)      # must wait for the release
    t.join()
    assert released and c is a
    snap = pool.snapshot()
    assert snap["acquires"] == 3 and snap["waits"] == 1
    pool.release(b)
    pool.release(c)
    assert pool.snapshot()["free"] == 2


def test_staging_pool_blocking_acquire_still_works():
    """No timeout = the historical contract: block until a slab frees."""
    pool = StagingPool(slab_pages=1, num_slabs=1)
    slab = pool.acquire(full(PAGE_SIZE, 7))
    assert (slab[:PAGE_SIZE] == 7).all()
    timer = threading.Timer(0.05, pool.release, args=(slab,))
    timer.start()
    again = pool.acquire(full(PAGE_SIZE, 9))
    assert (again[:PAGE_SIZE] == 9).all()



# ===========================================================================
# twins of tests/test_mr_prefetch.py
# ===========================================================================

def _fault_then_replay(mr, addr, num_pages=1, client=None):
    d = _desc(Verb.READ, mr.region.node_id, addr, num_pages)
    fault, registered = mr.serve(d, client=client)
    assert fault
    assert mr.serve(d, client=client) == (False, 0)   # replay hits
    return registered


# ---------------------------------------------------------------------------
# ExtentPrefetcher (unit)
# ---------------------------------------------------------------------------

def test_prefetcher_needs_confidence_before_predicting():
    pf = ExtentPrefetcher(depth=4, degree=2, confidence=2)
    assert pf.observe(0, 10, 1) == []        # first touch: no stream yet
    assert pf.observe(0, 11, 1) == []        # stride 1, conf 1 < 2
    out = pf.observe(0, 12, 1)               # conf 2: established
    assert out == [(13, 1), (14, 1)]


def test_prefetcher_depth_and_degree_bound_the_lookahead():
    pf = ExtentPrefetcher(depth=3, degree=8, confidence=1)
    pf.observe(0, 0, 1)
    out = pf.observe(0, 1, 1)
    # degree allows 8, depth allows only 3 strides past the demand page
    assert out == [(2, 1), (3, 1), (4, 1)]


def test_prefetcher_never_repredicts_covered_ground():
    pf = ExtentPrefetcher(depth=8, degree=2, confidence=1)
    pf.observe(0, 0, 1)
    assert pf.observe(0, 1, 1) == [(2, 1), (3, 1)]
    # the next observation resumes from the high-water mark, not page+1
    assert pf.observe(0, 2, 1) == [(4, 1), (5, 1)]
    assert pf.observe(0, 3, 1) == [(6, 1), (7, 1)]


def test_prefetcher_strided_and_descending_streams():
    pf = ExtentPrefetcher(depth=4, degree=2, confidence=2)
    for p in (0, 8, 16):
        out = pf.observe(1, p, 2)
    assert out == [(24, 2), (32, 2)]         # stride 8, npages preserved
    for p in (100, 96, 92):
        out = pf.observe(2, p, 1)
    assert out == [(88, 1), (84, 1)]         # descending scan


def test_prefetcher_broken_stride_resets_confidence():
    pf = ExtentPrefetcher(depth=4, degree=2, confidence=2)
    for p in (0, 1, 2):
        pf.observe(0, p, 1)
    assert pf.observe(0, 50, 1) == []        # break: conf resets
    assert pf.observe(0, 51, 1) == []        # conf 1 < 2
    assert pf.observe(0, 52, 1) != []        # re-established


def test_prefetcher_random_traffic_emits_almost_nothing():
    rng = np.random.default_rng(3)
    pf = ExtentPrefetcher(depth=4, degree=4, confidence=2)
    emitted = sum(len(pf.observe(0, int(p), 1))
                  for p in rng.integers(0, 10_000, 512))
    assert emitted <= 8      # only accidental stride repeats slip through


def test_prefetcher_streams_are_per_client():
    pf = ExtentPrefetcher(depth=4, degree=1, confidence=2)
    # interleaved clients would break a shared stream; per-client works
    for p in (0, 1):
        pf.observe(0, p, 1)
        pf.observe(1, 1000 - p, 1)
    assert pf.observe(0, 2, 1) == [(3, 1)]
    assert pf.observe(1, 998, 1) == [(997, 1)]


# ---------------------------------------------------------------------------
# spec / policy plumbing
# ---------------------------------------------------------------------------

def test_mr_prefetch_roundtrips_through_spec():
    spec = box.ClusterSpec(registered_pages=64,
                           mr_prefetch={"depth": 8, "degree": 4})
    again = box.ClusterSpec.from_json(spec.to_json())
    assert again == spec
    assert again.mr_prefetch == {"depth": 8, "degree": 4}
    assert box.ClusterSpec().mr_prefetch is None


def test_mr_prefetch_validation():
    box.ClusterSpec(mr_prefetch={"depth": 0}).validate()
    with pytest.raises(ValueError, match="unknown mr_prefetch"):
        box.ClusterSpec(mr_prefetch={"dpeth": 4}).validate()
    with pytest.raises(ValueError, match="depth"):
        box.ClusterSpec(mr_prefetch={"depth": -1}).validate()
    with pytest.raises(ValueError, match="degree"):
        box.ClusterSpec(mr_prefetch={"degree": 0}).validate()
    with pytest.raises(ValueError, match="confidence"):
        box.ClusterSpec(mr_prefetch={"confidence": 0}).validate()


def test_mr_prefetch_knobs_reach_the_cache():
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=16,
                           mr_prefetch={"depth": 8, "degree": 3,
                                        "confidence": 1})
    with box.open(spec, device="cpu") as s:
        pf = s.directory.lookup(s.donors[0]).mr.prefetcher
        assert isinstance(pf, ExtentPrefetcher)
        assert (pf.depth, pf.degree, pf.confidence) == (8, 3, 1)
    # depth 0 (the default) leaves the cache predictor-free
    with box.open(box.ClusterSpec(num_donors=1, donor_pages=256,
                                  replication=1, nic_scale=2e-8,
                                  registered_pages=16), device="cpu") as s:
        assert s.directory.lookup(s.donors[0]).mr.prefetcher is None


def test_mr_prefetch_rejects_non_mrconfig_policy():
    from repro_torch.box.policies import register_policy

    class NotAnMRConfig2:
        def build(self, region):
            return None

    register_policy("mr", "custom-mr-for-prefetch-test")(NotAnMRConfig2)
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, mr="custom-mr-for-prefetch-test",
                           mr_prefetch={"depth": 4})
    with pytest.raises(ValueError, match="mr_prefetch.*only applies"):
        box.open(spec, device="cpu")


def test_mr_config_builds_prefetcher_only_when_depth_positive():
    region = RemoteRegion(0, 64)
    assert MRConfig(capacity_pages=8).build(region).prefetcher is None
    mr = MRConfig(capacity_pages=8, prefetch_depth=4).build(region)
    assert isinstance(mr.prefetcher, ExtentPrefetcher)


# ---------------------------------------------------------------------------
# MRCache background-prefetch protocol (unit)
# ---------------------------------------------------------------------------

def _pf_cache(capacity=16, depth=8, degree=2, confidence=2, pages=64):
    pf = ExtentPrefetcher(depth=depth, degree=degree, confidence=confidence)
    return MRCache(RemoteRegion(1, pages), capacity, prefetcher=pf)


def test_serve_queues_predictions_and_prefetch_registers_them():
    mr = _pf_cache(confidence=2)
    for p in (0, 1, 2):
        _fault_then_replay(mr, p, client=0)
    cands = mr.drain_predictions()
    assert cands and all(c[0] > 2 for c in cands)
    assert mr.drain_predictions() == []          # drained once
    got = sum(mr.prefetch_register(p, n) for p, n in cands)
    assert got == len(cands)
    snap = mr.snapshot()
    assert snap["prefetch"]["issued"] == got
    assert snap["prefetch"]["useful"] == 0       # not demanded yet
    # the demand access hits — no fault — and credits usefulness
    first = cands[0][0]
    assert mr.serve(_desc(Verb.READ, 1, first), client=0) == (False, 0)
    pf = mr.snapshot()["prefetch"]
    assert pf["useful"] == 1
    assert pf["accuracy"] == pytest.approx(1 / got)


def test_replays_do_not_feed_the_stride_stream():
    """A fault's replay is the same logical access arriving late — if it
    were observed the out-of-order page would break the stream."""
    mr = _pf_cache(confidence=2, degree=1)
    d0, d1, d2 = (_desc(Verb.READ, 1, p) for p in (0, 1, 2))
    # fault all three first, replay later (out of order)
    for d in (d0, d1, d2):
        assert mr.serve(d, client=0)[0]
    for d in (d2, d0, d1):                       # replay order scrambled
        assert mr.serve(d, client=0) == (False, 0)
    # the stream saw 0,1,2 (fault order), not the scrambled replays
    cands = mr.drain_predictions()
    assert cands == [(3, 1)]


def test_prefetch_register_loses_demand_race_cleanly():
    mr = _pf_cache()
    _fault_then_replay(mr, 5)                    # demand got there first
    assert mr.prefetch_register(5, 1) == 0       # re-check: nothing to do
    assert mr.snapshot()["registrations"] == 1
    assert mr.snapshot()["prefetch"]["issued"] == 0
    # out-of-region candidates clamp / drop instead of registering air
    assert mr.prefetch_register(63, 4) == 1      # clamped to the region
    assert mr.prefetch_register(64, 2) == 0
    assert mr.prefetch_register(-2, 1) == 0


def test_evicted_untouched_prefetch_counts_wasted():
    mr = _pf_cache(capacity=4)
    assert mr.prefetch_register(10, 2) == 2
    for p in range(4):                           # churn the tiny cache
        _fault_then_replay(mr, p)
    pf = mr.snapshot()["prefetch"]
    assert pf["issued"] == 2
    assert pf["wasted"] == 2                     # evicted before demand
    assert pf["accuracy"] == 0.0


def test_disabled_snapshot_carries_zeroed_prefetch_shape():
    snap = MRCache.disabled_snapshot()
    assert snap["prefetch"] == {"issued": 0, "useful": 0, "wasted": 0,
                                "accuracy": 0.0, "queued": 0,
                                "bg_pu_us": 0.0}


# ---------------------------------------------------------------------------
# NIC scheduling rule (white box)
# ---------------------------------------------------------------------------

def test_foreground_run_beats_a_queued_prefetch():
    """Workers start on first post, so a hint queued beforehand is
    pending when the first foreground job arrives — foreground-first
    means the job still FAULTS on its page (the prefetch covering it
    had no chance to run first)."""
    with Fabric(device="cpu", scale=2e-8) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        region = fab.directory.lookup(1)
        region.mr = mr = MRCache(region, capacity_pages=16)
        donor._prefetch_queue.append((5, 1))     # covers the job's page
        cq = CompletionQueue(cq_id=881)
        _preload(donor, [_desc(Verb.READ, 1, 5)], cq)
        wcs = _drain(cq, 1)
        # prefetch did NOT preempt: the demand access paid its fault
        assert wcs[0].status is WCStatus.RNR_RETRY_ERR
        # afterwards the idle worker drains the hint, loses the re-check
        # race (the fault registered page 5), and registers nothing new
        deadline = time.perf_counter() + 5.0
        while donor._prefetch_queue and time.perf_counter() < deadline:
            time.sleep(0.001)
        assert not donor._prefetch_queue
        assert mr.snapshot()["registrations"] == 1
        assert mr.snapshot()["prefetch"]["issued"] == 0


def test_idle_workers_run_prefetch_and_charge_background_pu():
    with Fabric(device="cpu", scale=2e-8) as fab:
        donor = fab.add_node(1, donor_pages=64)
        fab.add_node(0)
        region = fab.directory.lookup(1)
        region.mr = mr = MRCache(region, capacity_pages=16)
        cq = CompletionQueue(cq_id=882)
        _preload(donor, [_desc(Verb.READ, 1, 0)], cq)   # starts workers
        _drain(cq, 1)
        donor._queue_prefetch([(10, 2), (20, 1)])
        deadline = time.perf_counter() + 5.0
        while (mr.snapshot()["prefetch"]["issued"] < 3
               and time.perf_counter() < deadline):
            time.sleep(0.001)
        svc = donor.service_snapshot()["mr"]
        assert svc["prefetch"]["issued"] == 3
        assert svc["prefetch"]["queued"] == 0
        assert svc["prefetch"]["bg_pu_us"] > 0.0
        # a prefetched page serves as a plain hit, zero registration
        assert mr.serve(_desc(Verb.READ, 1, 10, 2), client=0) == (False, 0)
        assert donor.stats.registrations.value == 3  # fault + 2 bg extents


# ---------------------------------------------------------------------------
# end to end: sequential scan, prefetch on vs off
# ---------------------------------------------------------------------------

def _scan_faults(prefetch, npages=48):
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=32,
                           serve_workers=2, rnr_backoff_us=10.0,
                           mr_prefetch=prefetch)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        eng = s.engine(0)
        out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        for p in range(npages):
            eng.read(donor, p, 1, out=out).wait(30)
            time.sleep(0.002)        # leave the idle window prefetch uses
        return _mr_stats(s, donor)


def test_sequential_scan_prefetch_turns_faults_into_hits():
    off = _scan_faults(None)
    on = _scan_faults({"depth": 8, "degree": 4, "confidence": 2})
    assert off["faults"] == 48                   # every first touch faults
    assert off["prefetch"]["issued"] == 0
    assert on["faults"] <= off["faults"] // 2    # the stream got covered
    assert on["prefetch"]["issued"] > 0
    assert on["prefetch"]["useful"] > 0
    assert on["prefetch"]["accuracy"] >= 0.5
    assert on["prefetch"]["bg_pu_us"] > 0.0


# (the calibration-band case runs the analytic backend: its twin is in
# tests/test_torch_model.py)


# ---------------------------------------------------------------------------
# decorrelated RNR jitter (satellite)
# ---------------------------------------------------------------------------

def _jitter_session(**kw):
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, **kw)
    return box.open(spec, device="cpu")


def test_rnr_jitter_seed_roundtrips_through_spec():
    spec = box.ClusterSpec(rnr_jitter_seed=42)
    assert box.ClusterSpec.from_json(spec.to_json()).rnr_jitter_seed == 42
    assert box.ClusterSpec().rnr_jitter_seed is None


def test_default_backoff_stays_deterministic_doubling():
    with _jitter_session(rnr_backoff_us=200.0) as s:
        eng = s.engine(0)
        assert eng._rnr_rng is None
        assert [eng._rnr_delay_us(7, a) for a in (1, 2, 3)] \
            == [200.0, 400.0, 800.0]
        # stateless: a second request sees the same schedule
        assert eng._rnr_delay_us(8, 1) == 200.0
        assert eng._retry_delay_us == {}


def test_seeded_jitter_is_bounded_and_reproducible():
    base, limit = 100.0, 4
    cap = base * 2 ** (limit - 1)

    def delays(seed):
        with _jitter_session(rnr_backoff_us=base, rnr_retry_limit=limit,
                             rnr_jitter_seed=seed) as s:
            eng = s.engine(0)
            return [eng._rnr_delay_us(5, a) for a in range(1, 7)]

    a, b, c = delays(7), delays(7), delays(11)
    assert a == b                                # same seed, same schedule
    assert c != a                                # different seed differs
    assert all(base <= d <= cap for d in a)
    assert len(set(a)) > 1                       # actually jittered


def test_jittered_replay_still_serves_and_cleans_up():
    with _jitter_session(registered_pages=8, rnr_backoff_us=10.0,
                         rnr_jitter_seed=3) as s:
        donor = s.donors[0]
        eng = s.engine(0)
        data = tb(np.random.default_rng(0).integers(
            0, 255, PAGE_SIZE).astype(np.uint8))
        eng.write(donor, 3, data).wait(30)       # faults, replays jittered
        out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        eng.read(donor, 3, 1, out=out).wait(30)
        assert (out == data).all()
        assert s.stats()["client"]["0"]["box"]["rnr_retries"] >= 1
        assert eng._retry_delay_us == {}         # completion swept state



# ===========================================================================
# twins of tests/test_mr_replacement.py
# ===========================================================================

POLICIES = {
    "lru": MRCache,
    "slru": SLRUMRCache,
    "freq-extent": FreqExtentMRCache,
}
CONFIGS = {"lru": MRConfig, "slru": SLRUConfig, "freq-extent": FreqExtentConfig}


def _hit(mr, addr, num_pages=1):
    assert mr.serve(_desc(Verb.READ, mr.region.node_id, addr,
                          num_pages)) == (False, 0)


# ---------------------------------------------------------------------------
# the MR cache's invariants, per policy
# ---------------------------------------------------------------------------

@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    return request.param


def _make(policy, capacity=4, pages=64):
    return POLICIES[policy](RemoteRegion(1, pages), capacity)


def test_policy_registry_builds_the_right_cache(policy):
    from repro_torch.box.policies import create_policy
    from repro_torch.box.spec import PolicySpec
    cfg = create_policy("mr", PolicySpec(policy,
                                         {"capacity_pages": 8}))
    assert isinstance(cfg, CONFIGS[policy])
    mr = cfg.build(RemoteRegion(1, 64))
    assert type(mr) is POLICIES[policy]
    assert mr.capacity == 8
    assert CONFIGS[policy]().build(RemoteRegion(1, 64)) is None  # 0 = off


def test_warm_extent_registers_once_per_residency(policy):
    mr = _make(policy, capacity=8)
    assert _fault_then_replay(mr, 3, 2) == 2
    for _ in range(10):
        _hit(mr, 3, 2)
    snap = mr.snapshot()
    assert snap["registrations"] == 2
    assert snap["faults"] == 1 and snap["replays"] == 1


def test_eviction_deregisters_and_bounds_residency(policy):
    mr = _make(policy, capacity=4)
    for p in range(6):
        _fault_then_replay(mr, p)
    snap = mr.snapshot()
    assert snap["resident_pages"] <= 4
    assert snap["deregistrations"] >= 2
    assert snap["registrations"] == 6


def test_pinned_pages_survive_eviction_pressure(policy):
    mr = _make(policy, capacity=2)
    d0 = _desc(Verb.READ, 1, 0)
    assert mr.serve(d0) == (True, 1)        # pinned until replayed
    for p in range(1, 6):
        _fault_then_replay(mr, p)           # churn the other frame
    assert mr.snapshot()["pinned_pages"] == 1
    assert mr.serve(d0) == (False, 0)       # replay hits, unpins
    snap = mr.snapshot()
    assert snap["pinned_pages"] == 0
    assert snap["replays"] == 6


def test_all_pinned_overflows_transiently(policy):
    mr = _make(policy, capacity=1)
    da, db = _desc(Verb.READ, 1, 0), _desc(Verb.READ, 1, 1)
    assert mr.serve(da) == (True, 1)
    assert mr.serve(db) == (True, 1)        # victim pinned: overflow
    assert mr.snapshot()["resident_pages"] == 2
    assert mr.serve(da) == (False, 0)
    assert mr.serve(db) == (False, 0)
    _fault_then_replay(mr, 2)               # next fault sweeps the excess
    snap = mr.snapshot()
    assert snap["resident_pages"] <= 2      # bounded again (cap + batch)
    assert snap["deregistrations"] >= 1


def test_box_open_churn_stays_byte_exact(policy):
    """Full engine round trip per policy: a universe 4x the capacity
    keeps evict/re-register churn running; every page reads back
    exactly what was last written."""
    spec = box.ClusterSpec(num_donors=1, donor_pages=256, replication=1,
                           nic_scale=2e-8, registered_pages=8,
                           rnr_backoff_us=10.0, mr=policy)
    with box.open(spec, device="cpu") as s:
        donor = s.donors[0]
        eng = s.engine(0)
        universe = 32
        rng = np.random.default_rng(5)
        version = {}
        for p in rng.integers(0, universe, 96):
            p = int(p)
            v = version.get(p, 0) + 1
            version[p] = v
            data = full(PAGE_SIZE, (37 * p + 101 * v) % 256)
            eng.write(donor, p, data).wait(30)
        buf = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        for p, v in version.items():
            eng.read(donor, p, 1, out=buf).wait(30)
            assert (buf == (37 * p + 101 * v) % 256).all(), \
                f"policy {policy}: page {p} corrupt"
        st = s.stats()["nic"][str(donor)]["service"]["mr"]
        assert st["deregistrations"] > 0            # churn happened
        assert st["pinned_pages"] == 0
        assert st["resident_pages"] <= st["capacity_pages"]


# ---------------------------------------------------------------------------
# SLRU white box: scan resistance
# ---------------------------------------------------------------------------

def test_slru_replay_touch_does_not_promote():
    """Fault + replay is ONE logical access: the page stays on
    probation; only a genuine re-use promotes it."""
    mr = SLRUMRCache(RemoteRegion(1, 64), 8, protected_fraction=0.5)
    _fault_then_replay(mr, 0)
    snap = mr.snapshot()
    assert snap["probation_pages"] == 1 and snap["protected_pages"] == 0
    _hit(mr, 0)                             # the re-use promotes
    snap = mr.snapshot()
    assert snap["probation_pages"] == 0 and snap["protected_pages"] == 1


def test_slru_scan_does_not_flush_the_hot_set():
    """Plain LRU loses the hot set to any long single-touch scan; SLRU
    keeps re-used pages in the protected segment and churns the scan
    through probation."""
    mr = SLRUMRCache(RemoteRegion(1, 256), 8, protected_fraction=0.5)
    hot = range(4)
    for p in hot:
        _fault_then_replay(mr, p)
        _hit(mr, p)                         # promoted to protected
    for p in range(100, 130):               # 30-page single-touch scan
        _fault_then_replay(mr, p)
    for p in hot:
        _hit(mr, p)                         # still resident: no faults
    snap = mr.snapshot()
    assert snap["faults"] == 4 + 30         # the hot re-reads added none
    assert snap["protected_pages"] == 4
    # the control: plain LRU at the same capacity DOES flush the hot set
    lru = MRCache(RemoteRegion(1, 256), 8)
    for p in hot:
        _fault_then_replay(lru, p)
        _hit(lru, p)
    for p in range(100, 130):
        _fault_then_replay(lru, p)
    assert all(lru.serve(_desc(Verb.READ, 1, p))[0] for p in hot)


def test_slru_promotion_overflow_demotes_to_probation():
    mr = SLRUMRCache(RemoteRegion(1, 64), 8, protected_fraction=0.25)
    assert mr.protected_cap == 2
    for p in range(3):
        _fault_then_replay(mr, p)
        _hit(mr, p)                         # promote: 3 > cap of 2
    snap = mr.snapshot()
    assert snap["protected_pages"] == 2     # oldest demoted back
    assert snap["probation_pages"] == 1
    assert snap["resident_pages"] == 3      # demotion never loses a page


def test_slru_victims_come_from_probation_first():
    mr = SLRUMRCache(RemoteRegion(1, 64), 4, protected_fraction=0.5)
    _fault_then_replay(mr, 0)
    _hit(mr, 0)                             # page 0 protected
    for p in range(1, 4):
        _fault_then_replay(mr, p)           # probation full
    _fault_then_replay(mr, 10)              # evicts probation LRU (page 1)
    assert not mr.serve(_desc(Verb.READ, 1, 0))[0]   # protected survived
    assert mr.serve(_desc(Verb.READ, 1, 1))[0]       # probation victim


# ---------------------------------------------------------------------------
# freq-extent white box: whole-extent victims
# ---------------------------------------------------------------------------

def test_freq_extent_evicts_the_cold_extent_whole():
    mr = FreqExtentMRCache(RemoteRegion(1, 64), 8)
    assert _fault_then_replay(mr, 0, 4) == 4        # extent A: pages 0-3
    for _ in range(3):
        _hit(mr, 0, 4)                              # A is hot
    assert _fault_then_replay(mr, 10, 2) == 2       # extent B: cold
    assert _fault_then_replay(mr, 20, 4) == 4       # C forces eviction
    snap = mr.snapshot()
    assert snap["deregistrations"] == 2             # ALL of B, only B
    assert snap["extents"] == 2                     # A and C
    _hit(mr, 0, 4)                                  # A intact, no fault
    assert mr.serve(_desc(Verb.READ, 1, 10, 2))[0]  # B gone: faults


def test_freq_extent_never_orphans_part_of_an_extent():
    """The failure mode this policy removes: page-granular LRU can evict
    half a multi-page extent, turning the next whole-extent access into
    a fault for the orphaned remainder. Victims here are whole extents,
    so residency is always a union of complete extents."""
    mr = FreqExtentMRCache(RemoteRegion(1, 64), 6)
    _fault_then_replay(mr, 0, 3)                    # extent A
    _fault_then_replay(mr, 10, 3)                   # extent B
    _fault_then_replay(mr, 20, 3)                   # evicts exactly one
    snap = mr.snapshot()
    assert snap["resident_pages"] == 6
    assert snap["deregistrations"] == 3             # one whole extent
    # whichever of A/B survived is FULLY resident, the other fully gone
    a = [p in mr._page_ext for p in range(0, 3)]
    b = [p in mr._page_ext for p in range(10, 13)]
    assert all(a) != all(b)
    assert all(a) or not any(a)
    assert all(b) or not any(b)


def test_freq_extent_frequency_beats_recency():
    """The hot-but-not-recent extent survives; LRU would evict it."""
    mr = FreqExtentMRCache(RemoteRegion(1, 64), 4)
    _fault_then_replay(mr, 0, 2)                    # extent A
    for _ in range(5):
        _hit(mr, 0, 2)                              # A: high frequency
    _fault_then_replay(mr, 10, 2)                   # extent B, more recent
    _fault_then_replay(mr, 20, 2)                   # eviction decision
    assert not mr.serve(_desc(Verb.READ, 1, 0, 2))[0]    # A survived
    assert mr.serve(_desc(Verb.READ, 1, 10, 2))[0]       # B was victim


def test_freq_extent_pinned_extents_are_skipped_whole():
    mr = FreqExtentMRCache(RemoteRegion(1, 64), 4)
    d = _desc(Verb.READ, 1, 0, 2)
    assert mr.serve(d) == (True, 2)                 # A pinned (no replay)
    _fault_then_replay(mr, 10, 2)                   # extent B
    _fault_then_replay(mr, 20, 2)                   # must not touch A
    assert mr.serve(d) == (False, 0)                # A's replay still hits
    assert mr.serve(_desc(Verb.READ, 1, 10, 2))[0]  # B was the victim



# ===========================================================================
# parity with repro: one trace through both packages' donor-side caches
# ===========================================================================

ref_core = pytest.importorskip("repro.core")


@pytest.mark.parametrize("policy", ["lru", "slru", "freq-extent"])
def test_parity_mr_cache_trace(policy):
    """The same zipf-ish extent trace, faults replayed as the NIC does,
    through both packages' MR caches: identical decisions and counters."""
    classes = {"lru": (MRCache, ref_core.MRCache), "slru": (SLRUMRCache, ref_core.SLRUMRCache),
               "freq-extent": (FreqExtentMRCache, ref_core.FreqExtentMRCache)}[policy]
    rng = np.random.default_rng(13)
    trace = [(int(rng.integers(0, 96)), int(rng.integers(1, 4)), int(rng.integers(0, 3)))
             for _ in range(400)]
    out = []
    for cache_cls, region_cls, wr, td, verb in (
            (classes[0], RemoteRegion, WorkRequest, TransferDescriptor, Verb.READ),
            (classes[1], ref_core.RemoteRegion, ref_core.WorkRequest,
             ref_core.TransferDescriptor, ref_core.Verb.READ)):
        mr = cache_cls(region_cls(1, 128), 24)
        decisions = []
        for addr, n, client in trace:
            req = wr(verb=verb, dest_node=1, remote_addr=addr, num_pages=n)
            d = td(verb=verb, dest_node=1, remote_addr=addr, num_pages=n, requests=[req])
            got = mr.serve(d, client=client)
            decisions.append(got)
            if got[0]:
                decisions.append(mr.serve(d, client=client))    # the replay
        out.append((decisions, mr.snapshot()))
    assert out[0] == out[1]


def test_parity_hot_cache_trace_bytes_and_counters():
    """Writes, reads through the tier and promotions, in one order, on
    both packages' regions with a hot-page tier: the same bytes served and
    the same tier counters."""
    rng = np.random.default_rng(29)
    regions = (RemoteRegion(1, 64), ref_core.RemoteRegion(1, 64))
    tiers = (CacheTier(regions[0], 8, promote_after=2),
             ref_core.CacheTier(regions[1], 8, promote_after=2))
    for r, t in zip(regions, tiers):
        r.cache = t
    served = ([], [])
    for _ in range(300):
        page, n = int(rng.integers(0, 62)), int(rng.integers(1, 3))
        if rng.random() < 0.3:
            data = rng.integers(0, 256, n * PAGE_SIZE).astype(np.uint8)
            regions[0].write(page, tb(data))
            regions[1].write(page, data)
            continue
        for k, (r, t) in enumerate(zip(regions, tiers)):
            out = (torch.empty(n * PAGE_SIZE, dtype=torch.uint8) if k == 0
                   else np.empty(n * PAGE_SIZE, np.uint8))
            flags, promote = t.begin_reads([(page, n, out)])
            if not (flags[0] and t.read_into(page, n, out)):
                r.readv([(page, n, out)])
            for p in promote:
                t.promote(p)
            served[k].append((flags, promote, np.asarray(out).copy()))
    for a, b in zip(*served):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
    assert tiers[0].snapshot() == tiers[1].snapshot()
    assert tiers[0].snapshot()["hits"] > 0 and tiers[0].snapshot()["write_throughs"] > 0
