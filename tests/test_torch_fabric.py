"""repro_torch's fabric, paging and multi-client engine against the reference.

Twins of ``tests/test_fabric.py`` and ``tests/test_multiclient.py`` on
``repro_torch`` with torch ``uint8`` buffers on the CPU: per-node NICs and
links, fault injection, replicated paging with failover to disk, shared
donors, donor-side acks, RNR retry and the in-flight write buffer. The
tests whose assertion is a wall-clock latency or throughput ratio have no
twin (ROADMAP lists them). Last, one single-threaded paging sequence runs
through both packages and must leave the same bytes and counters.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small buffers; leave the cores to parallel test workers

from repro_torch.core import (PAGE_SIZE, BoxConfig, RDMABox,  # noqa: E402
                              RegionDirectory, RemoteRegion, TransferError,
                              WCStatus)
from repro_torch.fabric import Fabric, FaultPlan, FaultState, LinkConfig  # noqa: E402
from repro_torch.memory import MemoryCluster, OffloadConfig, OffloadManager  # noqa: E402


def tb(a):
    """A numpy array's bytes as a CPU torch tensor (shared memory)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def full(n, value):
    return torch.full((n,), value, dtype=torch.uint8)


# ===========================================================================
# twins of tests/test_fabric.py
# ===========================================================================

FAST = BoxConfig(nic_scale=2e-8)


def fast_cfg(**kw):
    return BoxConfig(nic_scale=2e-8, **kw)


def page(seed):
    return tb(np.random.default_rng(seed).integers(0, 255, PAGE_SIZE).astype(np.uint8))


# ---------------------------------------------------------------------------
# fabric topology
# ---------------------------------------------------------------------------

def test_fabric_owns_per_node_nics_and_links():
    with Fabric(device="cpu", scale=2e-8) as fab:
        fab.add_node(0)
        fab.add_node(1, donor_pages=256)
        fab.add_node(2, donor_pages=256)
        assert fab.nodes() == [0, 1, 2]
        assert fab.peers_of(0) == [1, 2]
        assert fab.nic(1).node_id == 1
        # links are directed, created on demand, and stable
        assert fab.link(0, 1) is fab.link(0, 1)
        assert fab.link(0, 1) is not fab.link(1, 0)
        # donated regions are in the shared directory
        assert fab.directory.lookup(1).num_pages == 256


def test_box_joins_fabric_and_channels_bind_links():
    with Fabric(device="cpu", scale=2e-8) as fab:
        for n in (1, 2):
            fab.add_node(n, donor_pages=1024)
        box = RDMABox(0, fabric=fab, config=FAST)
        try:
            assert box.peers == [1, 2]
            for peer in (1, 2):
                for ch in box.channels.channels[peer]:
                    assert ch.link is fab.link(0, peer)
            data = page(0)
            box.write(1, 3, data).wait(10)
            out = torch.zeros(PAGE_SIZE, dtype=torch.uint8)
            box.read(1, 3, 1, out=out).wait(10)
            assert np.array_equal(out, data)
            assert fab.link(0, 1).transfers.value >= 2
        finally:
            box.close()


def test_legacy_rdmabox_signature_still_works():
    directory = RegionDirectory()
    directory.register(RemoteRegion(1, 512))
    box = RDMABox(0, directory, [1], config=FAST, device="cpu")
    try:
        data = page(1)
        box.write(1, 0, data).wait(10)
        out = torch.zeros(PAGE_SIZE, dtype=torch.uint8)
        box.read(1, 0, 1, out=out).wait(10)
        assert np.array_equal(out, data)
    finally:
        box.close()


# ---------------------------------------------------------------------------
# error completions + TransferFuture reporting
# ---------------------------------------------------------------------------

def test_transfer_error_carries_completion_details():
    plan = FaultPlan(seed=3).flaky(1, prob=1.0, max_errors=2)
    # rnr_retry_limit=0: this test targets the error-surfacing path, so the
    # in-engine transient retry (tested in test_multiclient.py) is disabled
    with MemoryCluster(num_donors=1, donor_pages=512,
                       box_config=fast_cfg(rnr_retry_limit=0),
                       faults=plan, device="cpu") as c:
        fut = c.box.write(1, 0, page(2))
        err = fut.exception(timeout=10)          # non-raising accessor
        assert isinstance(err, TransferError)
        assert err.status == WCStatus.RNR_RETRY_ERR and err.transient
        assert err.dest_node == 1 and err.wr_id >= 0
        assert "RNR_RETRY_ERR" in str(err) and "dest_node=1" in str(err)
        with pytest.raises(TransferError):
            fut.wait(1)
        # transient budget (2) exhausted by merged retries ⇒ healthy again
        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline:
            if c.box.write(1, 1, page(3)).exception(timeout=10) is None:
                break
        else:
            pytest.fail("transient fault never cleared")
        assert c.box.poller.stats.errors.value >= 1
        assert c.box.stats()["nic"]["wc_errors"] >= 1


# ---------------------------------------------------------------------------
# replication failover (the acceptance scenarios)
# ---------------------------------------------------------------------------

def test_midrun_crash_r2_no_corruption_no_disk():
    """replication=2 + scripted mid-run donor crash: the second replica
    absorbs every read; zero data corruption, zero disk reads."""
    with MemoryCluster(num_donors=3, donor_pages=4096, box_config=FAST,
                       replication=2, evict_after=1, device="cpu") as c:
        pages = {i: page(i) for i in range(48)}
        for pid in range(24):                       # first half, healthy
            c.paging.swap_out(pid, pages[pid], wait=True)
        c.crash_donor(1)                            # scripted mid-run crash
        for pid in range(24, 48):                   # second half, degraded
            c.paging.swap_out(pid, pages[pid], wait=True)
        for pid, data in pages.items():
            assert np.array_equal(c.paging.swap_in(pid), data), pid
        st = c.paging.stats()
        assert st["disk_reads"] == 0, st            # replica absorbed it all
        assert st["evictions"] >= 1 and 1 in st["failed_donors"]
        assert st["read_failovers"] >= 1            # at least one fell over


def test_midrun_crash_r1_disk_fallback():
    """replication=1: once the only replica's donor dies, reads must fall
    back to disk — and only then."""
    with MemoryCluster(num_donors=2, donor_pages=4096, box_config=FAST,
                       replication=1, write_through_disk=True,
                       evict_after=1, device="cpu") as c:
        pages = {i: page(100 + i) for i in range(16)}
        for pid, data in pages.items():
            c.paging.swap_out(pid, data, wait=True)
        assert c.paging.stats()["disk_reads"] == 0
        # healthy: no disk reads
        for pid, data in pages.items():
            assert np.array_equal(c.paging.swap_in(pid), data)
        assert c.paging.stats()["disk_reads"] == 0
        c.crash_donor(1)
        c.crash_donor(2)
        for pid, data in pages.items():
            assert np.array_equal(c.paging.swap_in(pid), data), pid
        st = c.paging.stats()
        assert st["disk_fallback_reads"] >= len(pages)
        assert st["disk_reads"] >= len(pages)


def test_disk_only_when_all_replicas_fail():
    """With r=2, killing ONE donor of the pair must not touch disk; killing
    both donors of a page's replica set must."""
    with MemoryCluster(num_donors=2, donor_pages=4096, box_config=FAST,
                       replication=2, write_through_disk=True,
                       evict_after=1, device="cpu") as c:
        data = page(7)
        c.paging.swap_out(0, data, wait=True)
        c.crash_donor(c.paging.replicas(0)[0][0])
        assert np.array_equal(c.paging.swap_in(0), data)
        assert c.paging.stats()["disk_fallback_reads"] == 0
        c.crash_donor(c.paging.replicas(0)[1][0])
        assert np.array_equal(c.paging.swap_in(0), data)
        assert c.paging.stats()["disk_fallback_reads"] == 1


def test_write_failover_persists_page_when_all_replicas_fail():
    with MemoryCluster(num_donors=2, donor_pages=4096, box_config=FAST,
                       replication=2, evict_after=2, device="cpu") as c:
        c.crash_donor(1)
        c.crash_donor(2)
        data = page(9)
        c.paging.swap_out(0, data, wait=True)       # all writes error
        assert c.paging.stats()["disk_writes"] >= 1
        assert np.array_equal(c.paging.swap_in(0), data)    # served by disk


def test_donor_eviction_after_repeated_failures():
    plan = FaultPlan(seed=5).crash(1, after_ops=0)
    with MemoryCluster(num_donors=3, donor_pages=4096, box_config=FAST,
                       replication=2, evict_after=3, faults=plan, device="cpu") as c:
        for pid in range(12):
            c.paging.swap_out(pid, page(pid), wait=True)
        st = c.paging.stats()
        assert 1 in st["failed_donors"] and st["evictions"] == 1
        # evicted donor receives no further traffic
        before = c.fabric.link(0, 1).transfers.value
        for pid in range(12, 24):
            c.paging.swap_out(pid, page(pid), wait=True)
        assert c.fabric.link(0, 1).transfers.value == before


# (the straggler and link-congestion tests assert wall-clock ratios and
# have no twin: ROADMAP lists them)

# ---------------------------------------------------------------------------
# offload tier on a degraded fabric
# ---------------------------------------------------------------------------

def test_stale_replica_never_serves_reads():
    """A replica whose acked write failed must not serve reads after its
    donor recovers — the other replica has the newer bytes."""
    with MemoryCluster(num_donors=3, donor_pages=4096, box_config=FAST,
                       replication=2, evict_after=10, device="cpu") as c:
        v1, v2 = page(21), page(22)
        c.paging.swap_out(0, v1, wait=True)
        primary = c.paging.replicas(0)[0][0]
        c.crash_donor(primary)
        c.paging.swap_out(0, v2, wait=True)     # primary write fails → stale
        c.recover_donor(primary)                # donor healthy again, but...
        got = c.paging.swap_in(0)
        assert np.array_equal(got, v2), "stale replica served a read"
        # a later successful write clears the stale mark
        c.paging.swap_out(0, v1, wait=True)
        assert np.array_equal(c.paging.swap_in(0), v1)


def test_add_node_idempotent_keeps_region_data():
    with Fabric(device="cpu", scale=2e-8) as fab:
        fab.add_node(1, donor_pages=64)
        fab.directory.lookup(1).write(0, full(PAGE_SIZE, 5))
        fab.add_node(1, donor_pages=64)         # must NOT zero the region
        assert fab.directory.lookup(1).read(0, 1).max() == 5


def test_fault_trigger_whichever_first():
    from repro_torch.fabric import FaultState
    # ops trigger fires even though the time trigger is far in the future
    plan = FaultPlan().crash(1, after_ops=3, at_us=1e12)
    st = FaultState(plan, now_us=lambda: 0.0)
    assert st.transfer_status(0, 1) is None      # op 1
    assert st.transfer_status(0, 1) is None      # op 2
    assert st.transfer_status(0, 1) == WCStatus.RETRY_EXC_ERR   # op 3 fires
    # pure time trigger: default after_ops=0 must NOT fire on ops
    plan2 = FaultPlan().crash(1, at_us=1e12)
    st2 = FaultState(plan2, now_us=lambda: 0.0)
    assert all(st2.transfer_status(0, 1) is None for _ in range(5))


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "parallel"])
def test_offload_roundtrip_survives_donor_crash(parallel):
    """Twin of test_offload_roundtrip_survives_donor_crash (serial fetch,
    donor 2 crashed) and test_parallel_fetch_survives_donor_crash (burst
    fetch, the second donor crashed)."""
    with MemoryCluster(num_donors=3, donor_pages=4096, box_config=FAST,
                       replication=2, evict_after=1, device="cpu") as c:
        om = OffloadManager(c.paging, OffloadConfig(acked_writes=True,
                                                    fetch_parallel=parallel))
        t = torch.from_numpy(np.random.default_rng(3 if parallel else 0).normal(
            size=(64, 64)).astype(np.float32))
        om.offload("w", t, wait=True)
        c.crash_donor(c.donors[1])
        got = om.fetch("w")
        assert got.dtype == torch.float32 and torch.equal(got, t)
        assert c.paging.stats()["disk_reads"] == 0


# ===========================================================================
# twins of tests/test_multiclient.py
# ===========================================================================

# ---------------------------------------------------------------------------
# shared donors: several endpoints on one fabric
# ---------------------------------------------------------------------------

def test_two_boxes_share_one_donor():
    """Two RDMABox endpoints attach to one fabric and page against the
    same donor without corrupting each other (disjoint page ranges)."""
    with Fabric(device="cpu", scale=2e-8) as fab:
        fab.add_node(9, donor_pages=1024)
        boxes = [RDMABox(0, fabric=fab, peers=[9], config=FAST),
                 RDMABox(1, fabric=fab, peers=[9], config=FAST)]
        try:
            datas = {b: [page(100 * b + i) for i in range(8)]
                     for b in range(2)}
            futs = []
            for b, box in enumerate(boxes):
                for i, d in enumerate(datas[b]):
                    futs.append(box.write(9, 512 * b + i, d))
            for f in futs:
                f.wait(10)
            for b, box in enumerate(boxes):
                for i, d in enumerate(datas[b]):
                    out = torch.zeros(PAGE_SIZE, dtype=torch.uint8)
                    box.read(9, 512 * b + i, 1, out=out).wait(10)
                    assert np.array_equal(out, d), (b, i)
            # the donor's NIC served BOTH clients and accounted per client
            service = fab.nic(9).fairness_snapshot()
            assert set(service) == {0, 1}
            assert all(s["ops"] >= 16 for s in service.values())
        finally:
            for box in boxes:
                box.close()


def test_completions_route_through_donor_nic_and_reverse_link():
    """Donor→client ack traffic rides the donor's own NIC and the
    donor→client link, not a client-side shortcut."""
    with Fabric(device="cpu", scale=2e-8) as fab:
        fab.add_node(1, donor_pages=256)
        box = RDMABox(0, fabric=fab, config=FAST)
        try:
            for i in range(8):
                box.write(1, i, page(i)).wait(10)
            donor = fab.nic(1).stats.snapshot()
            assert donor["served_wqes"] >= 8
            assert donor["acks_sent"] >= 8
            assert donor["bytes_on_wire"] > 0          # acks on donor egress
            # reverse link carried the acks (as control messages)
            assert fab.link(1, 0).transfers.value >= 8
            assert fab.link(1, 0).ctrl_transfers.value >= 8
            # client still owns the CQE accounting
            assert box.nic.stats.completions.value >= 8
        finally:
            box.close()


def test_multiclient_paging_uses_disjoint_donor_slices():
    """Same page_id on two clients must land on different donor pages —
    placement is per-client, so slices are carved disjoint."""
    with MemoryCluster(num_donors=2, donor_pages=2048, box_config=FAST,
                       replication=2, num_clients=2, device="cpu") as c:
        assert c.clients == [0, 1] and c.donors == [2, 3]
        a0 = set(c.pagings[0].replicas(0)) | set(c.pagings[0].replicas(17))
        a1 = set(c.pagings[1].replicas(0)) | set(c.pagings[1].replicas(17))
        assert not (a0 & a1), "clients share remote pages"
        v0, v1 = page(1), page(2)
        c.pagings[0].swap_out(0, v0, wait=True)
        c.pagings[1].swap_out(0, v1, wait=True)
        assert np.array_equal(c.pagings[0].swap_in(0), v0)
        assert np.array_equal(c.pagings[1].swap_in(0), v1)


# ---------------------------------------------------------------------------
# admission fairness across clients sharing a donor
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# congestion-aware admission window
# ---------------------------------------------------------------------------

def test_faultplan_congestion_episode_expires():
    """FaultPlan.congest(..., until_us=) lifts itself once virtual time
    passes the bound."""
    t = [0.0]
    st = FaultState(FaultPlan().congest(0, 1, 8.0, until_us=100.0),
                    now_us=lambda: t[0])
    assert st.wire_multiplier(0, 1) == 8.0
    assert st.serve_multiplier(1, 0) == 1.0     # reverse path unaffected
    t[0] = 101.0
    assert st.wire_multiplier(0, 1) == 1.0      # episode over
    # imperative episodes work the same way
    st.congest_link(0, 1, 5.0)
    assert st.wire_multiplier(0, 1) == 5.0
    st.clear_congestion(0, 1)
    assert st.wire_multiplier(0, 1) == 1.0


# ---------------------------------------------------------------------------
# bounded in-engine RNR retry
# ---------------------------------------------------------------------------

def test_rnr_retry_recovers_transient_fault():
    """A transient RNR streak shorter than the retry budget is absorbed
    in-engine: the caller's future succeeds, data lands."""
    plan = FaultPlan(seed=11).flaky(1, prob=1.0, max_errors=2)
    with MemoryCluster(num_donors=1, donor_pages=512,
                       box_config=fast_cfg(rnr_retry_limit=3),
                       faults=plan, device="cpu") as c:
        data = page(5)
        fut = c.box.write(1, 0, data)
        wc = fut.wait(10)                        # no error surfaces
        assert wc.status is WCStatus.SUCCESS
        assert c.box.rnr_retries.value >= 2
        out = torch.zeros(PAGE_SIZE, dtype=torch.uint8)
        c.box.read(1, 0, 1, out=out).wait(10)
        assert np.array_equal(out, data)


def test_rnr_retry_budget_exhausted_surfaces_error():
    """A persistent RNR fault outlives the retry budget and surfaces as a
    transient TransferError (paging failover takes it from there)."""
    plan = FaultPlan(seed=12).flaky(1, prob=1.0)         # never heals
    with MemoryCluster(num_donors=1, donor_pages=512,
                       box_config=fast_cfg(rnr_retry_limit=2),
                       faults=plan, device="cpu") as c:
        fut = c.box.write(1, 0, page(6))
        err = fut.exception(timeout=10)
        assert isinstance(err, TransferError) and err.transient
        assert err.status is WCStatus.RNR_RETRY_ERR
        assert c.box.rnr_retries.value == 2      # exactly the budget
        assert c.box.stats()["rnr_retries"] == 2


# ---------------------------------------------------------------------------
# offload tier across the multi-client fabric
# ---------------------------------------------------------------------------

def test_write_buffer_serves_inflight_swapouts():
    """An async swap-out racing its own swap-in must serve the fresh
    bytes from the in-flight write buffer — RDMA only orders ops within
    one QP, and a page's write and read ride different channels."""
    with MemoryCluster(num_donors=3, donor_pages=1 << 13,
                       box_config=FAST, device="cpu") as c:
        datas = {i: page(500 + i) for i in range(64)}
        for pid, d in datas.items():
            c.paging.swap_out(pid, d)           # async, not awaited
            got = c.paging.swap_in(pid)         # immediate read-back
            assert np.array_equal(got, d), pid
        assert c.paging.stats()["write_buffer_hits"] >= 1
        c.box.flush()
        # buffer drains once writes complete; reads now come from donors
        deadline = time.perf_counter() + 5
        while c.paging._wb and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert not c.paging._wb, "write buffer never drained"
        hits_before = c.paging.stats()["write_buffer_hits"]
        for pid, d in datas.items():
            assert np.array_equal(c.paging.swap_in(pid), d), pid
        assert c.paging.stats()["write_buffer_hits"] == hits_before


def test_overlapping_swapouts_converge_to_newest_bytes():
    """Two async swap-outs of the same page ride different QPs and may
    land at the donor in either order; the write buffer pins the newest
    bytes until ALL writes drain, then settles the race with one final
    rewrite — so both the in-flight reads and the donor's eventual state
    are the newest version."""
    with MemoryCluster(num_donors=3, donor_pages=1 << 13,
                       box_config=FAST, device="cpu") as c:
        final = {}
        for pid in range(16):
            v1, v2 = page(700 + pid), page(900 + pid)
            c.paging.swap_out(pid, v1)          # async
            c.paging.swap_out(pid, v2)          # overlapping, same page
            final[pid] = v2
            assert np.array_equal(c.paging.swap_in(pid), v2), pid
        c.box.flush()
        deadline = time.perf_counter() + 10
        while c.paging._wb and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert not c.paging._wb, "write buffer never drained"
        for pid, want in final.items():         # donor state converged
            assert np.array_equal(c.paging.swap_in(pid), want), pid


def test_per_client_engines_are_independent():
    """Each client owns its merge queue / admission window: exhausting
    one client's window must not block the other client's traffic."""
    # the link latency keeps each transfer in flight ~1ms real, so the
    # burst below reliably fills the 8-page window (at a near-instant
    # scale completions can drain as fast as the posting loop submits)
    with MemoryCluster(num_donors=1, donor_pages=2048,
                       box_config=BoxConfig(nic_scale=1e-6,
                                            window_bytes=8 * PAGE_SIZE),
                       link=LinkConfig(latency_us=500.0),
                       replication=1, num_clients=2, device="cpu") as c:
        # client 0: a burst far beyond its window
        futs0 = [c.boxes[0].write(c.donors[0], i, page(i)) for i in range(64)]
        # client 1 proceeds regardless
        t0 = time.perf_counter()
        c.boxes[1].write(c.donors[0], 0, page(99)).wait(10)
        assert time.perf_counter() - t0 < 5.0
        for f in futs0:
            f.wait(30)
        assert c.boxes[0].stats()["admission_blocked"] >= 1



# ===========================================================================
# parity with repro: one paging sequence through both packages
# ===========================================================================

def test_parity_paging_sequence_with_a_crash():
    """Swap-outs, a donor crash, more swap-outs, batch swap-out, swap-ins
    and a prefetch batch, single-threaded, on both packages: the same
    bytes come back and the deterministic counters agree."""
    ref_memory = pytest.importorskip("repro.memory")
    ref_core = pytest.importorskip("repro.core")
    rng = np.random.default_rng(21)
    pages = [rng.integers(0, 256, PAGE_SIZE).astype(np.uint8) for _ in range(40)]
    out = {}
    for name, cluster, as_buf in (
            ("mine", lambda: MemoryCluster(num_donors=3, donor_pages=4096,
                                           box_config=FAST, replication=2,
                                           evict_after=1, device="cpu"), tb),
            ("ref", lambda: ref_memory.MemoryCluster(
                num_donors=3, donor_pages=4096,
                box_config=ref_core.BoxConfig(nic_scale=2e-8), replication=2,
                evict_after=1), lambda a: a)):
        with cluster() as c:
            for pid in range(16):
                c.paging.swap_out(pid, as_buf(pages[pid]), wait=True)
            c.crash_donor(c.donors[0])
            for pid in range(16, 32):
                c.paging.swap_out(pid, as_buf(pages[pid]), wait=True)
            c.paging.swap_out_batch([(pid, as_buf(pages[pid])) for pid in range(32, 40)])
            got = [np.asarray(c.paging.swap_in(pid)).copy() for pid in range(40)]
            bufs = [as_buf(np.zeros(PAGE_SIZE, np.uint8)) for _ in range(8)]
            ok = c.paging.prefetch_batch(list(zip(range(8), bufs))).resolve(10)
            st = c.paging.stats()
            out[name] = (got, [np.asarray(b).copy() for b in bufs], ok,
                         {k: st[k] for k in ("disk_reads", "disk_writes", "evictions",
                                             "failed_donors")},
                         [c.paging.replicas(p) for p in range(40)])
    mine, ref = out["mine"], out["ref"]
    for pid in range(40):
        np.testing.assert_array_equal(mine[0][pid], pages[pid])
        np.testing.assert_array_equal(mine[0][pid], ref[0][pid])
    for a, b in zip(mine[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    assert mine[2:] == ref[2:]
