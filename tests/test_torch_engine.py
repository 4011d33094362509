"""repro_torch's RDMAbox engine core against the reference ``repro.core``.

Twins of ``tests/test_engine.py``, ``test_merge_queue.py``,
``test_batching.py`` and ``test_hist.py`` on ``repro_torch`` with torch
``uint8`` buffers on the CPU, then parity cases that run the same inputs,
made from a numpy seed, through both packages: batching plans, merge-queue
drains, histogram snapshots, admission decisions and region bytes. Last,
the fault-classification rule: only a remote access fault becomes an error
completion; any other exception of a byte move reaches the caller as itself.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small buffers; leave the cores to parallel test workers
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import (PAGE_SIZE, AdmissionController,  # noqa: E402
                              BatchPolicy, BatchTransferError, BoxConfig,
                              MergeQueue, PollConfig, PollMode, RDMABox,
                              RegionDirectory, RegMode, RemotePagingSystem,
                              RemoteRegion, Verb, WorkRequest,
                              contiguous_runs, plan, resolve_reg_mode)
from repro_torch.core.hist import LatencyHistogram  # noqa: E402


def tb(a):
    """A numpy array's bytes as a CPU torch tensor (shared memory)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def full(n, value):
    return torch.full((n,), value, dtype=torch.uint8)


# ===========================================================================
# twins of tests/test_engine.py
# ===========================================================================

def make_box(poll_mode=PollMode.ADAPTIVE, scq=0, policy=BatchPolicy.HYBRID,
             window=4 << 20, peers=(1, 2), scale=2e-8):
    directory = RegionDirectory()
    for n in peers:
        directory.register(RemoteRegion(n, 4096))
    cfg = BoxConfig(batch_policy=policy, window_bytes=window,
                    nic_scale=scale,
                    poll=PollConfig(mode=poll_mode, scq_count=scq or 1))
    return RDMABox(0, directory, list(peers), config=cfg, device="cpu")


def test_write_read_roundtrip_all_policies():
    data = tb((np.arange(PAGE_SIZE) % 251).astype(np.uint8))
    for policy in BatchPolicy:
        box = make_box(policy=policy)
        try:
            futs = [box.write(1, i, data) for i in range(16)]
            for f in futs:
                f.wait(10)
            out = torch.zeros(PAGE_SIZE, dtype=torch.uint8)
            box.read(1, 7, 1, out=out).wait(10)
            assert np.array_equal(out, data), policy
        finally:
            box.close()


@pytest.mark.parametrize("mode", [PollMode.BUSY, PollMode.EVENT,
                                  PollMode.EVENT_BATCH, PollMode.SCQ,
                                  PollMode.HYBRID_TIMER, PollMode.ADAPTIVE])
def test_all_polling_modes_complete(mode):
    box = make_box(poll_mode=mode)
    try:
        data = torch.ones(PAGE_SIZE, dtype=torch.uint8)
        futs = [box.write(1 + (i % 2), i % 64, data) for i in range(64)]
        for f in futs:
            f.wait(15)
        assert box.poller.stats.handled.value >= 1
    finally:
        box.close()


def test_merging_under_load_reduces_ops():
    box = make_box(window=64 << 10, scale=1e-7)
    try:
        data = torch.ones(PAGE_SIZE, dtype=torch.uint8)
        futs = []

        def worker(tid):
            fs = [box.write(1, tid * 256 + i, data) for i in range(64)]
            futs.extend(fs)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            f.wait(30)
        st = box.stats()
        assert st["nic"]["rdma_ops"] < st["merge"]["submitted"], \
            "expected adjacency merging under load"
    finally:
        box.close()


def test_admission_bounds_inflight():
    box = make_box(window=128 << 10, scale=1e-7)
    try:
        data = torch.ones(PAGE_SIZE, dtype=torch.uint8)
        maxseen = 0
        futs = []
        for i in range(512):
            futs.append(box.write(1, i % 1024, data))
            maxseen = max(maxseen, box.admission.in_flight_bytes)
        for f in futs:
            f.wait(30)
        # single WQE may overshoot by its own size; never unbounded
        assert maxseen <= (128 << 10) + box.cfg.max_drain * PAGE_SIZE
    finally:
        box.close()


# ---------------------------------------------------------------------------
# batched zero-copy hot path (write_pages / read_pages / BatchFuture)
# ---------------------------------------------------------------------------

def test_batch_write_read_roundtrip():
    box = make_box()
    try:
        datas = [full(PAGE_SIZE, (i * 7 + 1) % 251)
                 for i in range(48)]
        box.write_pages(1, [(i, datas[i]) for i in range(48)]).wait(15)
        buf = torch.empty(48 * PAGE_SIZE, dtype=torch.uint8)
        views = [buf[i * PAGE_SIZE:(i + 1) * PAGE_SIZE] for i in range(48)]
        assert box.read_pages(1, list(enumerate(views))).errors(15) == {}
        for i in range(48):
            assert np.array_equal(views[i], datas[i]), i
        st = box.stats()
        # the pre-formed vector drains in a few big merges, not 96 solos
        assert st["merge"]["drained_requests"] >= 96
        assert st["merge"]["merge_ratio"] > 1.0
        assert st["pending_requests"] == 0
    finally:
        box.close()


def test_batch_error_map_isolates_failed_pages():
    box = make_box()          # donor regions are 4096 pages
    try:
        data = torch.ones(PAGE_SIZE, dtype=torch.uint8)
        fut = box.write_pages(1, [(0, data), (5000, data)])
        errs = fut.errors(10)
        assert list(errs) == [5000]         # only the bad page, keyed by page
        with pytest.raises(BatchTransferError) as ei:
            fut.wait(10)
        assert 5000 in ei.value.errors
        out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        box.read(1, 0, 1, out=out).wait(10)
        assert np.array_equal(out, data)    # the good page still landed
    finally:
        box.close()


def test_batch_callbacks_fire_before_waiter_released():
    fired = []
    box = make_box()
    try:
        data = torch.ones(PAGE_SIZE, dtype=torch.uint8)
        cbs = [lambda wc, i=i: fired.append(i) for i in range(8)]
        box.write_pages(1, [(i, data) for i in range(8)],
                        callbacks=cbs).wait(10)
        assert sorted(fired) == list(range(8))
    finally:
        box.close()


def test_callback_errors_counted_not_raised():
    box = make_box()
    try:
        data = torch.ones(PAGE_SIZE, dtype=torch.uint8)

        def bad(wc):
            raise ValueError("boom")

        box.write(1, 0, data, callback=bad).wait(10)
        box.write(1, 1, data, callback=bad).wait(10)
        assert box.stats()["callback_errors"] == 2
        out = torch.empty(PAGE_SIZE, dtype=torch.uint8)     # engine still healthy
        box.read(1, 0, 1, out=out).wait(10)
    finally:
        box.close()


def test_flush_event_driven_and_timeout_path():
    box = make_box()
    try:
        data = torch.ones(PAGE_SIZE, dtype=torch.uint8)
        release = threading.Event()

        def block(wc):
            release.wait(10)        # holds the completion path hostage

        fut = box.write(1, 0, data, callback=block)
        with pytest.raises(TimeoutError):
            box.flush(timeout=0.2)  # transfer can't finish: must time out
        release.set()
        fut.wait(10)
        box.flush(timeout=5)        # drains promptly once completed
        assert box.stats()["pending_requests"] == 0
    finally:
        box.close()


def test_region_vectorized_zero_copy_roundtrip():
    region = RemoteRegion(1, 64)
    a = full(PAGE_SIZE, 3)
    b = full(2 * PAGE_SIZE, 4)
    region.writev([(0, a), (10, b)])
    out_a = torch.empty(PAGE_SIZE, dtype=torch.uint8)
    out_b = torch.empty(2 * PAGE_SIZE, dtype=torch.uint8)
    region.readv([(0, 1, out_a), (10, 2, out_b)])
    assert np.array_equal(out_a, a) and np.array_equal(out_b, b)
    with pytest.raises(IndexError):
        region.readv([(63, 2, out_b)])      # second page out of range
    with pytest.raises(IndexError):
        region.writev([(-1, a)])


# ---------------------------------------------------------------------------
# remote paging (replication + failover + disk)
# ---------------------------------------------------------------------------

def test_paging_roundtrip_and_failover():
    box = make_box(peers=(1, 2, 3))
    try:
        ps = RemotePagingSystem(box, donor_pages=4096, replication=2)
        rng = np.random.default_rng(0)
        pages = {i: tb(rng.integers(0, 255, PAGE_SIZE).astype(np.uint8))
                 for i in range(40)}
        for pid, data in pages.items():
            ps.swap_out(pid, data, wait=True)
        for pid, data in pages.items():
            assert np.array_equal(ps.swap_in(pid), data)
        # kill the primary replica of page 3 → must read from replica 2
        ps.fail_node(ps.replicas(3)[0][0])
        assert np.array_equal(ps.swap_in(3), pages[3])
    finally:
        box.close()


def test_paging_disk_fallback_with_write_through():
    box = make_box(peers=(1, 2))
    try:
        ps = RemotePagingSystem(box, donor_pages=4096, replication=2,
                                write_through_disk=True)
        data = full(PAGE_SIZE, 7)
        ps.swap_out(5, data, wait=True)
        ps.fail_node(1)
        ps.fail_node(2)
        assert np.array_equal(ps.swap_in(5), data)   # disk tier
        assert ps.disk.reads >= 1
    finally:
        box.close()


def test_paging_batch_swapout_and_prefetch():
    box = make_box(peers=(1, 2, 3))
    try:
        ps = RemotePagingSystem(box, donor_pages=4096, replication=2)
        rng = np.random.default_rng(1)
        pages = {i: tb(rng.integers(0, 255, PAGE_SIZE).astype(np.uint8))
                 for i in range(32)}
        ps.swap_out_batch(list(pages.items()))
        bufs = {pid: torch.empty(PAGE_SIZE, dtype=torch.uint8) for pid in pages}
        batch = ps.prefetch_batch([(pid, bufs[pid]) for pid in pages])
        assert all(batch.resolve(10))
        for pid, data in pages.items():
            assert np.array_equal(bufs[pid], data), pid
        # a replica marked stale by a failed acked write must not serve
        # prefetches — corrupt the primary's bytes, mark it stale, and the
        # batch read must come from the fresh secondary
        d0, r0 = ps.replicas(1)[0]
        box.directory.lookup(d0).write(r0, torch.zeros(PAGE_SIZE, dtype=torch.uint8))
        with ps._lock:
            ps._stale.add((d0, 1))
        buf = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        assert ps.prefetch_batch([(1, buf)]).resolve(10) == [True]
        assert np.array_equal(buf, pages[1])
        # failed prefetches report False and leave failover to swap_in
        ps.fail_node(ps.replicas(0)[0][0])
        ps.fail_node(ps.replicas(0)[1][0])
        buf = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        assert ps.prefetch_batch([(0, buf)]).resolve(5) == [False]
    finally:
        box.close()


def test_replica_placement_disjoint():
    box = make_box(peers=(1, 2, 3))
    try:
        ps = RemotePagingSystem(box, donor_pages=4096, replication=2)
        seen = {}
        for pid in range(ps.capacity_pages):
            for node, addr in ps.replicas(pid):
                key = (node, addr)
                assert key not in seen, f"collision {key}: {pid} vs {seen[key]}"
                seen[key] = pid
    finally:
        box.close()


def test_adaptive_polls_fewer_wakeups_than_event():
    """Adaptive polling should consume far fewer interrupt contexts than
    event-triggered mode for the same completion stream (Fig. 5)."""
    results = {}
    for mode in (PollMode.EVENT, PollMode.ADAPTIVE):
        box = make_box(poll_mode=mode, scale=1e-7)
        try:
            data = torch.ones(PAGE_SIZE, dtype=torch.uint8)
            futs = [box.write(1, i % 512, data) for i in range(256)]
            for f in futs:
                f.wait(30)
            results[mode] = box.poller.stats.wakeups.value
        finally:
            box.close()
    assert results[PollMode.ADAPTIVE] <= results[PollMode.EVENT]



# ===========================================================================
# twins of tests/test_merge_queue.py
# ===========================================================================

def wr(dest, addr, n=1, verb=Verb.WRITE):
    return WorkRequest(verb=verb, dest_node=dest, remote_addr=addr, num_pages=n)


# ---------------------------------------------------------------------------
# contiguous_runs
# ---------------------------------------------------------------------------

@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 64),
                          st.integers(1, 4)), max_size=40))
@settings(max_examples=200, deadline=None)
def test_runs_preserve_and_merge(reqs):
    requests = [wr(d, a, n) for d, a, n in reqs]
    runs = contiguous_runs(requests)
    # every request appears exactly once
    flat = [r for run in runs for r in run]
    assert sorted(r.wr_id for r in flat) == sorted(r.wr_id for r in requests)
    for run in runs:
        # within a run: same dest, same verb, strictly adjacent
        for a, b in zip(run, run[1:]):
            assert a.dest_node == b.dest_node
            assert a.verb == b.verb
            assert b.remote_addr == a.end_addr


@given(st.integers(0, 63), st.integers(1, 16))
@settings(max_examples=50, deadline=None)
def test_adjacent_sequence_merges_to_one(start, n):
    requests = [wr(1, start + i) for i in range(n)]
    runs = contiguous_runs(requests)
    assert len(runs) == 1 and len(runs[0]) == n


def test_nonadjacent_do_not_merge():
    runs = contiguous_runs([wr(1, 0), wr(1, 2), wr(2, 1)])
    assert len(runs) == 3


# ---------------------------------------------------------------------------
# batching policies (Table 1 semantics)
# ---------------------------------------------------------------------------

def _counts(groups):
    wqes = sum(len(d) for d, _ in groups)
    mmios = sum(1 if db else len(d) for d, db in groups)
    return wqes, mmios


def test_policy_wqe_mmio_accounting():
    reqs = [wr(1, 0), wr(1, 1), wr(1, 2), wr(1, 10)]   # run of 3 + lone
    single = plan(BatchPolicy.SINGLE, reqs)
    doorbell = plan(BatchPolicy.DOORBELL, reqs)
    bom = plan(BatchPolicy.BATCH_ON_MR, reqs)
    hybrid = plan(BatchPolicy.HYBRID, reqs)
    assert _counts(single) == (4, 4)
    assert _counts(doorbell) == (4, 1)   # chains but does NOT reduce WQEs
    assert _counts(bom) == (2, 2)        # merges runs, 1 MMIO per WQE
    assert _counts(hybrid) == (2, 1)     # fewest WQEs AND fewest MMIOs


@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 32)), min_size=1,
                max_size=30))
@settings(max_examples=100, deadline=None)
def test_policies_never_lose_requests(reqs):
    requests = [wr(d, a) for d, a in reqs]
    for policy in BatchPolicy:
        groups = plan(policy, requests)
        ids = sorted(r.wr_id for descs, _ in groups
                     for d in descs for r in d.requests)
        assert ids == sorted(r.wr_id for r in requests), policy


def test_hybrid_never_more_wqes_than_doorbell():
    rng = np.random.default_rng(0)
    for _ in range(20):
        reqs = [wr(int(d), int(a)) for d, a in
                zip(rng.integers(0, 3, 20), rng.integers(0, 40, 20))]
        h, _ = _counts(plan(BatchPolicy.HYBRID, reqs))
        d, _ = _counts(plan(BatchPolicy.DOORBELL, reqs))
        assert h <= d


# ---------------------------------------------------------------------------
# merge queue concurrency
# ---------------------------------------------------------------------------

def test_merge_queue_no_loss_under_concurrency():
    posted = []
    lock = threading.Lock()

    def poster(batch):
        with lock:
            posted.extend(r.wr_id for r in batch)

    mq = MergeQueue(poster)
    ids = []

    def worker(base):
        for i in range(200):
            r = wr(1, base * 1000 + i)
            ids.append(r.wr_id)
            mq.submit(r)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(posted) == sorted(ids)


def test_lone_request_posts_immediately():
    posted = []
    mq = MergeQueue(posted.append)
    mq.submit(wr(1, 5))
    assert len(posted) == 1 and len(posted[0]) == 1
    assert mq.solo_posts.value == 1


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_admission_window_blocks_and_releases():
    ac = AdmissionController(window_bytes=8192)
    assert ac.acquire(4096)
    assert ac.acquire(4096)
    assert not ac.acquire(1, timeout=0.05)        # window full
    ac.release(4096)
    assert ac.acquire(4096, timeout=1.0)
    assert ac.blocked_count.value >= 1


def test_admission_zero_inflight_always_admits():
    ac = AdmissionController(window_bytes=10)
    assert ac.acquire(4096)                        # oversized but first
    ac.release(4096)


def test_admission_disabled():
    ac = AdmissionController(window_bytes=None)
    for _ in range(100):
        assert ac.acquire(1 << 20)


@given(st.lists(st.integers(1, 4096), min_size=1, max_size=50))
@settings(max_examples=50, deadline=None)
def test_admission_inflight_never_negative(sizes):
    ac = AdmissionController(window_bytes=1 << 20)
    for s in sizes:
        ac.acquire(s)
    for s in sizes:
        ac.release(s)
    assert ac.in_flight_bytes == 0



# ===========================================================================
# twins of tests/test_batching.py
# ===========================================================================

# ---------------------------------------------------------------------------
# registration-mode resolution (Fig. 4 crossover)
# ---------------------------------------------------------------------------

def test_resolve_reg_mode_exact_crossover_boundary():
    # user space: strictly below the crossover stays preMR; AT the
    # crossover (and above) dynMR wins — the boundary itself is dynMR
    assert resolve_reg_mode(RegMode.AUTO, 99, kernel_space=False,
                            crossover_pages=100) == RegMode.PRE_MR
    assert resolve_reg_mode(RegMode.AUTO, 100, kernel_space=False,
                            crossover_pages=100) == RegMode.DYN_MR
    assert resolve_reg_mode(RegMode.AUTO, 101, kernel_space=False,
                            crossover_pages=100) == RegMode.DYN_MR


def test_resolve_reg_mode_kernel_vs_user_auto():
    # kernel space registers physical addresses: AUTO is dynMR at ANY size
    for n in (1, 99, 100, 10**6):
        assert resolve_reg_mode(RegMode.AUTO, n, kernel_space=True,
                                crossover_pages=100) == RegMode.DYN_MR
    # explicit modes pass through untouched in both spaces
    assert resolve_reg_mode(RegMode.PRE_MR, 10**6, kernel_space=True,
                            crossover_pages=1) == RegMode.PRE_MR
    assert resolve_reg_mode(RegMode.DYN_MR, 1, kernel_space=False,
                            crossover_pages=10**9) == RegMode.DYN_MR


def test_plan_auto_resolves_per_descriptor_size():
    # a merged run crossing the threshold flips to dynMR in user space
    # while a lone small request in the SAME drained batch stays preMR
    reqs = [wr(1, i) for i in range(8)] + [wr(1, 100)]
    groups = plan(BatchPolicy.HYBRID, reqs, RegMode.AUTO,
                  kernel_space=False, crossover_pages=4)
    descs = [d for dd, _ in groups for d in dd]
    assert next(d for d in descs if d.num_pages == 8).reg_mode == RegMode.DYN_MR
    assert next(d for d in descs if d.num_pages == 1).reg_mode == RegMode.PRE_MR
    groups = plan(BatchPolicy.HYBRID, reqs, RegMode.AUTO,
                  kernel_space=True, crossover_pages=4)
    assert all(d.reg_mode == RegMode.DYN_MR
               for dd, _ in groups for d in dd)


def test_hybrid_fewest_wqes_and_mmios_on_mixed_batch():
    # mixed adjacent runs + scattered strays across two destinations:
    # HYBRID must be simultaneously minimal on BOTH axes
    reqs = ([wr(1, i) for i in range(6)] + [wr(1, 20), wr(1, 40)]
            + [wr(2, j) for j in (0, 1, 2, 50)])
    counts = {p: _counts(plan(p, reqs)) for p in BatchPolicy}
    hw, hm = counts[BatchPolicy.HYBRID]
    for p, (w, m) in counts.items():
        assert hw <= w and hm <= m, p
    assert hw < counts[BatchPolicy.DOORBELL][0]      # strictly fewer WQEs
    assert hm < counts[BatchPolicy.BATCH_ON_MR][1]   # strictly fewer MMIOs


# ---------------------------------------------------------------------------
# batch submit path
# ---------------------------------------------------------------------------

def test_submit_many_drains_as_one_batch():
    posted = []
    mq = MergeQueue(posted.append, max_drain=64)
    mq.submit_many([wr(1, i) for i in range(50)])
    assert len(posted) == 1 and len(posted[0]) == 50
    assert mq.submitted.value == 50
    assert mq.drained_requests.value == 50
    assert mq.solo_posts.value == 0


def test_submit_many_respects_max_drain_windows():
    posted = []
    mq = MergeQueue(posted.append, max_drain=16)
    mq.submit_many([wr(1, i) for i in range(40)])
    assert [len(b) for b in posted] == [16, 16, 8]
    assert mq.drains.value == 3



# ===========================================================================
# twins of tests/test_hist.py
# ===========================================================================

# one bucket spans a 10^(1/16) ratio, so an upper-edge quantile estimate
# can overshoot the exact value by at most ~15.5% (and never undershoots)
BUCKET_RATIO = 10.0 ** (1.0 / 16.0)


def test_exact_quantiles_on_degenerate_distribution():
    # every sample identical: all quantiles clamp to the exact max
    h = LatencyHistogram()
    for _ in range(100):
        h.record(5.0)
    for q in (0.0, 50.0, 99.0, 99.9, 100.0):
        assert h.percentile(q) == 5.0
    snap = h.snapshot()
    assert snap["count"] == 100
    assert snap["mean_us"] == pytest.approx(5.0)
    assert snap["max_us"] == 5.0


def test_quantiles_on_known_two_point_distribution():
    # 99 samples at 10us, 1 at 1000us: p50 covers the 10us bucket,
    # p99.9 must see the outlier
    h = LatencyHistogram()
    h.record_many([10.0] * 99 + [1000.0])
    assert 10.0 <= h.percentile(50.0) <= 10.0 * BUCKET_RATIO
    assert 10.0 <= h.percentile(99.0) <= 10.0 * BUCKET_RATIO
    assert h.percentile(99.9) == 1000.0      # clamped to exact max


def test_quantiles_track_numpy_within_bucket_error():
    rng = np.random.default_rng(7)
    samples = rng.lognormal(mean=3.0, sigma=1.0, size=10_000)
    h = LatencyHistogram()
    h.record_many(samples)
    for q in (50.0, 90.0, 99.0, 99.9):
        exact = float(np.percentile(samples, q))
        est = h.percentile(q)
        # upper-edge estimate: never below exact, at most one bucket over
        assert exact <= est <= exact * BUCKET_RATIO * 1.001, (q, exact, est)


def test_percentiles_are_monotone_and_validated():
    h = LatencyHistogram()
    h.record_many([1.0, 5.0, 20.0, 400.0, 9000.0])
    qs = [0.0, 25.0, 50.0, 75.0, 99.0, 99.9, 100.0]
    vals = [h.percentile(q) for q in qs]
    assert vals == sorted(vals)
    assert vals[-1] == 9000.0
    with pytest.raises(ValueError):
        h.percentile(-1.0)
    with pytest.raises(ValueError):
        h.percentile(100.5)


def test_merge_of_per_worker_histograms_equals_direct():
    rng = np.random.default_rng(11)
    samples = rng.exponential(scale=50.0, size=4096) + 0.5
    direct = LatencyHistogram()
    direct.record_many(samples)
    workers = [LatencyHistogram() for _ in range(4)]
    for i, chunk in enumerate(np.array_split(samples, 4)):
        workers[i].record_many(chunk)
    merged = LatencyHistogram()
    for w in workers:
        merged.merge(w)
    m, d = merged.snapshot(), direct.snapshot()
    assert m["count"] == d["count"]
    assert m["max_us"] == d["max_us"]
    # summation order differs across workers: mean equal up to fp noise
    assert m["mean_us"] == pytest.approx(d["mean_us"])
    for q in (50.0, 99.0, 99.9):
        assert merged.percentile(q) == direct.percentile(q)


def test_merge_rejects_geometry_mismatch():
    h = LatencyHistogram()
    with pytest.raises(ValueError, match="geometry"):
        h.merge(LatencyHistogram(buckets_per_decade=8))
    with pytest.raises(ValueError, match="geometry"):
        h.merge(LatencyHistogram(lo_us=1.0))


def test_out_of_range_and_non_positive_samples():
    h = LatencyHistogram(lo_us=1.0, hi_us=1000.0)
    h.record(0.0)                       # dropped
    h.record(-3.0)                      # dropped
    assert h.snapshot()["count"] == 0
    h.record(0.01)                      # underflow bucket
    h.record(1e6)                       # overflow bucket
    snap = h.snapshot()
    assert snap["count"] == 2
    assert snap["max_us"] == 1e6        # max is tracked exactly
    assert h.percentile(100.0) == 1000.0   # overflow reports the hi edge
    assert h.percentile(0.0) <= 1.0     # underflow reports the low edge


def test_empty_snapshot_shape():
    empty = LatencyHistogram().snapshot()
    assert empty == LatencyHistogram.empty_snapshot()
    assert set(empty) == {"count", "mean_us", "p50_us", "p99_us",
                          "p999_us", "max_us"}
    assert all(v == 0 for v in empty.values())


def test_concurrent_recording_loses_nothing():
    h = LatencyHistogram()
    n, threads = 2000, 8

    def worker(tid):
        for i in range(n):
            h.record(1.0 + (tid * n + i) % 100)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert h.snapshot()["count"] == n * threads



# ===========================================================================
# parity with repro: the same inputs through both packages
# ===========================================================================

ref_core = pytest.importorskip("repro.core")


def _ref_wr(dest, addr, n, verb):
    return ref_core.WorkRequest(verb=ref_core.Verb(verb.value), dest_node=dest,
                                remote_addr=addr, num_pages=n)


def _seeded_requests(seed, count=40):
    """Random (dest, addr, pages, verb) tuples from a numpy seed: runs of
    adjacent pages, strays and both verbs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        dest, addr = int(rng.integers(1, 4)), int(rng.integers(0, 48))
        n, verb = int(rng.integers(1, 4)), Verb.READ if rng.random() < 0.3 else Verb.WRITE
        out.append((dest, addr, n, verb))
    return out


def _plan_shape(groups):
    return [([(d.verb.value, d.dest_node, d.remote_addr, d.num_pages, d.merged,
               d.chained, d.reg_mode.value, d.sge_count,
               [r.remote_addr for r in d.requests]) for d in descs], doorbell)
            for descs, doorbell in groups]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", list(BatchPolicy), ids=lambda p: p.value)
@pytest.mark.parametrize("kernel_space", [True, False])
def test_parity_batching_plan(seed, policy, kernel_space):
    reqs = _seeded_requests(seed)
    mine = plan(policy, [wr(d, a, n, v) for d, a, n, v in reqs], RegMode.AUTO,
                kernel_space=kernel_space, crossover_pages=4)
    theirs = ref_core.plan(ref_core.BatchPolicy(policy.value),
                           [_ref_wr(*r) for r in reqs], ref_core.RegMode.AUTO,
                           kernel_space=kernel_space, crossover_pages=4)
    assert _plan_shape(mine) == _plan_shape(theirs)
    assert _counts(mine) == _counts(theirs)


@pytest.mark.parametrize("seed", range(3))
def test_parity_merge_queue_submit_many(seed):
    reqs = _seeded_requests(seed, count=90)
    drained = {"mine": [], "ref": []}
    mq = MergeQueue(lambda b: drained["mine"].append(
        [(r.dest_node, r.remote_addr, r.num_pages, r.verb.value) for r in b]),
        max_drain=16)
    rq = ref_core.MergeQueue(lambda b: drained["ref"].append(
        [(r.dest_node, r.remote_addr, r.num_pages, r.verb.value) for r in b]),
        max_drain=16)
    mq.submit_many([wr(d, a, n, v) for d, a, n, v in reqs])
    rq.submit_many([_ref_wr(*r) for r in reqs])
    assert drained["mine"] == drained["ref"]
    for name in ("submitted", "drains", "drained_requests", "solo_posts"):
        assert getattr(mq, name).value == getattr(rq, name).value, name


@pytest.mark.parametrize("dist", ["lognormal", "exponential", "spread"])
def test_parity_histogram_snapshot(dist):
    from repro.core.hist import LatencyHistogram as RefHistogram
    rng = np.random.default_rng(3)
    samples = {"lognormal": rng.lognormal(3.0, 1.0, 5000),
               "exponential": rng.exponential(50.0, 5000) + 0.5,
               "spread": np.concatenate([rng.uniform(0.001, 1e7, 500), [0.0, -1.0]])}[dist]
    mine, theirs = LatencyHistogram(), RefHistogram()
    mine.record_many(samples.tolist())
    theirs.record_many(samples.tolist())
    assert mine.snapshot() == theirs.snapshot()
    for q in (0.0, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert mine.percentile(q) == theirs.percentile(q)


def test_parity_admission_decisions():
    rng = np.random.default_rng(5)
    mine = AdmissionController(window_bytes=64 << 10)
    theirs = ref_core.AdmissionController(window_bytes=64 << 10)
    held = []
    decisions = {"mine": [], "ref": []}
    for _ in range(300):
        if held and rng.random() < 0.4:
            n = held.pop(int(rng.integers(0, len(held))))
            mine.release(n)
            theirs.release(n)
            continue
        n = int(rng.integers(1, 9)) * PAGE_SIZE
        a, b = mine.acquire(n, timeout=0.0), theirs.acquire(n, timeout=0.0)
        decisions["mine"].append(a)
        decisions["ref"].append(b)
        if a:
            held.append(n)
        assert mine.in_flight_bytes == theirs.in_flight_bytes
    assert decisions["mine"] == decisions["ref"]
    assert False in decisions["mine"] and True in decisions["mine"]
    assert mine.snapshot() == theirs.snapshot()


def test_parity_region_writev_readv_bytes():
    rng = np.random.default_rng(9)
    mine, theirs = RemoteRegion(1, 64), ref_core.RemoteRegion(1, 64)
    parts = [(int(p), rng.integers(0, 256, n * PAGE_SIZE).astype(np.uint8))
             for p, n in ((0, 1), (3, 2), (10, 4), (20, 1), (40, 8))]
    mine.writev([(p, tb(d)) for p, d in parts])
    theirs.writev(parts)
    mine.write(50, tb(parts[1][1]))
    theirs.write(50, parts[1][1])
    spans = [(0, 5), (9, 6), (18, 4), (38, 12), (49, 4)]
    outs = [torch.empty(n * PAGE_SIZE, dtype=torch.uint8) for _, n in spans]
    ref_outs = [np.empty(n * PAGE_SIZE, np.uint8) for _, n in spans]
    mine.readv([(p, n, o) for (p, n), o in zip(spans, outs)])
    theirs.readv([(p, n, o) for (p, n), o in zip(spans, ref_outs)])
    for o, r in zip(outs, ref_outs):
        np.testing.assert_array_equal(o.numpy(), r)
    np.testing.assert_array_equal(mine.read(0, 64).numpy(), theirs.read(0, 64))


# ===========================================================================
# fault classification: a failed copy on this host is not a remote fault
# ===========================================================================

ILLEGAL_ACCESS = (RuntimeError,
                  "CUDA error: an illegal memory access was encountered")


class _FailingRegion(RemoteRegion):
    """A donor region whose byte copies fail with ``fail`` (an exception
    type and message), as a failed device copy (``RuntimeError``) or a
    host-side indexing bug (a plain ``IndexError``) would; its bounds check
    still raises the region's ``RemoteAccessError``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.fail = None

    def _raise_if_failing(self):
        if self.fail is not None:
            kind, msg = self.fail
            raise kind(msg)

    def writev(self, parts):
        self._raise_if_failing()
        super().writev(parts)

    def readv(self, parts):
        self._raise_if_failing()
        super().readv(parts)


@pytest.fixture
def failing_regions(monkeypatch):
    """Every donor region the next session builds is a ``_FailingRegion``
    (the fabric builds those of donors with a NIC, the session the bare
    ones)."""
    import repro_torch.core.region as region_mod
    import repro_torch.fabric.fabric as fabric_mod
    monkeypatch.setattr(region_mod, "RemoteRegion", _FailingRegion)
    monkeypatch.setattr(fabric_mod, "RemoteRegion", _FailingRegion)


@pytest.mark.parametrize("donor_nics", [True, False], ids=["donor-served", "client-side"])
def test_local_copy_error_reaches_the_caller_not_the_failover(donor_nics,
                                                             failing_regions):
    from repro_torch import box
    session = box.open(box.ClusterSpec(num_donors=2, donor_pages=1024, nic_scale=2e-8,
                                       donor_nics=donor_nics),
                       device="cpu")
    try:
        pager = session.pager()
        page = full(PAGE_SIZE, 9)
        pager.swap_out(0, page, wait=True)
        regions = [session.directory.lookup(n) for n in session.donors]
        for r in regions:
            r.fail = ILLEGAL_ACCESS
        with pytest.raises(RuntimeError, match="illegal memory access"):
            pager.swap_out(1, page, wait=True)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            pager.swap_in(0)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            pager.swap_out_batch([(2, page), (3, page)])
        engine = session.engine()
        with pytest.raises(RuntimeError, match="illegal memory access"):
            engine.write(session.donors[0], 5, page).wait(10)
        snap = pager.snapshot()
        assert snap["failed_donors"] == [] and snap["evictions"] == 0
        assert snap["write_failures"] == 0 and snap["read_failovers"] == 0
        assert snap["disk_writes"] == 0 and snap["disk_reads"] == 0
        assert pager._paging._strikes == {}
        # a remote access fault still is one: an out-of-region page
        for r in regions:
            r.fail = None
        err = engine.write(session.donors[0], 5000, page).exception(10)
        assert err is not None and err.status.name == "REMOTE_ERR"
        np.testing.assert_array_equal(pager.swap_in(0).numpy(), page.numpy())
    finally:
        session.close()


@pytest.mark.parametrize("donor_nics", [True, False], ids=["donor-served", "client-side"])
def test_host_index_error_in_a_move_is_not_a_remote_fault(donor_nics,
                                                         failing_regions):
    """A plain ``IndexError`` raised by the host's own code during a byte
    move (not the region's bounds check) reaches the caller as itself: no
    donor is struck and nothing goes to disk."""
    from repro_torch import box
    bug = (IndexError, "index 7 is out of bounds for dimension 0 with size 4")
    session = box.open(box.ClusterSpec(num_donors=2, donor_pages=1024, nic_scale=2e-8,
                                       donor_nics=donor_nics),
                       device="cpu")
    try:
        pager = session.pager()
        page = full(PAGE_SIZE, 4)
        pager.swap_out(0, page, wait=True)
        regions = [session.directory.lookup(n) for n in session.donors]
        for r in regions:
            r.fail = bug
        with pytest.raises(IndexError, match="out of bounds for dimension") as exc:
            pager.swap_out(1, page, wait=True)
        assert type(exc.value) is IndexError
        with pytest.raises(IndexError, match="out of bounds for dimension"):
            pager.swap_in(0)
        fut = session.engine().write(session.donors[0], 5, page)
        with pytest.raises(IndexError, match="out of bounds for dimension"):
            fut.wait(10)
        assert fut.completion().status.name == "LOCAL_ERR"
        snap = pager.snapshot()
        assert snap["failed_donors"] == [] and snap["write_failures"] == 0
        assert snap["disk_writes"] == 0 and snap["disk_reads"] == 0
        assert pager._paging._strikes == {}
    finally:
        session.close()


def test_region_and_directory_faults_are_remote_access_errors():
    from repro_torch.core.region import RemoteAccessError
    region, directory = RemoteRegion(1, 8), RegionDirectory()
    directory.register(region)
    with pytest.raises(RemoteAccessError, match="outside region of 8 pages"):
        region.write(7, torch.zeros(2 * PAGE_SIZE, dtype=torch.uint8))
    with pytest.raises(RemoteAccessError, match="node 2 donated no region"):
        directory.lookup(2)
    # callers that catch the reference's exceptions still catch them
    assert issubclass(RemoteAccessError, IndexError)
    assert issubclass(RemoteAccessError, KeyError)
