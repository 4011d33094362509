"""repro_torch.box, its KV store and tensor offload against the reference.

Twins of ``tests/test_box_api.py`` and of the gather, spill and offload
cases of ``tests/test_kv_cache.py`` on ``repro_torch`` with torch buffers
on the CPU; parity cases that run one spec and one single-threaded op
sequence through ``repro.box`` and ``repro_torch.box``; and the cases that
need the card (CUDA client buffers, a pool written by a kernel and spilled
with no synchronize in between), which decide at run time and skip here.
On a GPU machine without JAX:
``PYTHONPATH=src python -m pytest --noconftest tests/test_torch_box.py -k gpu``.
"""

import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small buffers; leave the cores to parallel test workers

import repro_torch.box as box  # noqa: E402
from repro_torch._deprecation import reset as reset_deprecation  # noqa: E402
from repro_torch.core import PAGE_SIZE  # noqa: E402
from repro_torch.memory import MemoryCluster, OffloadManager, PagedKVCache  # noqa: E402


def tb(a):
    """A numpy array's bytes as a CPU torch tensor (shared memory)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA client buffers")
    return torch.device("cuda")


# ===========================================================================
# twins of tests/test_box_api.py
# ===========================================================================

FAST = dict(nic_scale=1e-7, window_bytes=1 << 20)


def small_spec(**kw):
    base = dict(num_donors=3, donor_pages=2048, heap_pages=256,
                replication=2, **FAST)
    base.update(kw)
    return box.ClusterSpec(**base)


PAGE = tb(np.arange(PAGE_SIZE, dtype=np.uint8))


# ---- ClusterSpec ----------------------------------------------------------
def test_spec_round_trips_through_json():
    spec = box.ClusterSpec(
        num_donors=4, donor_pages=4096, num_clients=2, replication=2,
        heap_pages=128, link={"latency_us": 5.0, "gbps": 56.0},
        faults=[{"kind": "slow", "node": 3, "factor": 25.0},
                {"kind": "crash", "node": 4, "after_ops": 100}],
        admission={"name": "congestion", "params": {"shrink": 0.25}},
        polling={"name": "event_batch", "params": {"batch": 8}},
        nic_cost={"wire_us_per_page": 0.1})
    assert box.ClusterSpec.from_json(spec.to_json()) == spec
    assert box.ClusterSpec.from_dict(spec.to_dict()) == spec
    # policy refs coerce from bare strings too
    assert box.ClusterSpec(admission="static").admission == \
        box.PolicySpec("static")


def test_spec_rejects_unknown_fields_and_bad_layout():
    with pytest.raises(ValueError, match="unknown ClusterSpec fields"):
        box.ClusterSpec.from_dict({"num_donorz": 3})
    with pytest.raises(ValueError, match="heap_pages"):
        box.open(box.ClusterSpec(donor_pages=1024, num_clients=2,
                                 heap_pages=1024), device="cpu")


def test_open_accepts_dict_and_field_overrides():
    with box.open({"num_donors": 2, "donor_pages": 1024, **FAST},
                  replication=1, device="cpu") as session:
        assert session.spec.num_donors == 2
        assert session.spec.replication == 1


# ---- lifecycle ------------------------------------------------------------
def test_double_close_is_noop_and_capabilities_raise_closed():
    session = box.open(small_spec(), device="cpu")
    heap, pager, tensors = session.heap(), session.pager(), session.tensors()
    kv = session.kv_store(num_pages=8, page_tokens=4, kv_features=8)
    buf = heap.alloc(PAGE_SIZE)
    buf.write(PAGE).wait(10)
    engine = session.engine()
    session.close()
    session.close()                      # idempotent
    for fn in (lambda: session.engine(),
               lambda: session.heap(),
               lambda: session.stats(),
               lambda: session.flush(),
               lambda: heap.alloc(PAGE_SIZE),
               lambda: buf.write(PAGE),
               lambda: buf.readv([(0, torch.empty(PAGE_SIZE, dtype=torch.uint8))]),
               lambda: pager.swap_out(0, PAGE),
               lambda: pager.swap_in(0),
               lambda: tensors.offload("x", PAGE),
               lambda: kv.add_sequence(0),
               lambda: kv.spill(0),
               lambda: engine.write(session.donors[0], 0, PAGE),
               lambda: engine.write_pages(session.donors[0], [(0, PAGE)])):
        with pytest.raises(box.ClosedError):
            fn()


def test_close_fails_inflight_futures_with_closed_error():
    """Satellite: RDMABox.close() with a batch in flight must fail the
    outstanding futures with ClosedError, not strand waiters until the
    flush timeout."""
    spec = small_spec(heap_pages=512, nic_scale=1e-6,
                      link={"latency_us": 300000.0})   # 0.3s on the wire
    session = box.open(spec, device="cpu")
    buf = session.heap().alloc(16 * PAGE_SIZE)
    data = torch.zeros(16 * PAGE_SIZE, dtype=torch.uint8)
    batch = buf.writev([(i, data[i * PAGE_SIZE:(i + 1) * PAGE_SIZE])
                        for i in range(16)])
    single = buf.write(data[:PAGE_SIZE])
    assert not batch.done()
    session.close()
    with pytest.raises(box.ClosedError):
        batch.wait(1.0)
    with pytest.raises(box.ClosedError):
        batch.errors(1.0)
    with pytest.raises(box.ClosedError):
        single.wait(1.0)
    assert single.done() and batch.done()


# ---- capabilities ---------------------------------------------------------
def test_remote_heap_alloc_write_read_free_cycle():
    with box.open(small_spec(), device="cpu") as session:
        heap = session.heap()
        buf = heap.alloc(4 * PAGE_SIZE)
        data = tb(np.arange(4 * PAGE_SIZE, dtype=np.uint8))
        buf.writev([(i, data[i * PAGE_SIZE:(i + 1) * PAGE_SIZE])
                    for i in range(4)]).wait(10)
        assert np.array_equal(buf.read(), data)
        # partial read at an offset
        assert np.array_equal(buf.read(page_offset=1, num_pages=1),
                              data[PAGE_SIZE:2 * PAGE_SIZE])
        buf.free()
        buf.free()                      # idempotent
        with pytest.raises(box.ClosedError):
            buf.write(PAGE)
        # the span coalesced back into the free list
        snap = heap.snapshot()
        assert snap["live_buffers"] == 0
        assert all(v == session.spec.heap_pages
                   for v in snap["free_pages"].values())
        # exhaustion raises AllocError, not a silent overlap
        with pytest.raises(box.AllocError):
            heap.alloc(session.spec.heap_pages * PAGE_SIZE * 4)
        with pytest.raises(box.AllocError):
            heap.alloc(0)


def test_heap_disabled_when_spec_reserves_no_pages():
    with box.open(small_spec(heap_pages=0), device="cpu") as session:
        with pytest.raises(box.AllocError):
            session.heap().alloc(PAGE_SIZE)


def test_pager_and_tensor_store_roundtrip():
    with box.open(small_spec(), device="cpu") as session:
        pager = session.pager()
        pager.swap_out(5, PAGE, wait=True)
        assert np.array_equal(pager.swap_in(5), PAGE)
        primary = pager.replicas(5)[0][0]
        pager.fail_node(primary)
        assert np.array_equal(pager.swap_in(5), PAGE)   # replica failover
        store = session.tensors()
        arr = tb(np.random.default_rng(0).normal(size=(37, 11)).astype(np.float32))
        store.offload("opt/m", arr, wait=True)
        assert np.array_equal(store.fetch("opt/m"), arr)


def test_kv_store_spills_into_heap_arena():
    with box.open(small_spec(heap_pages=512), device="cpu") as session:
        kv = session.kv_store(num_pages=16, page_tokens=4, kv_features=8)
        kv.add_sequence(0)
        rng = np.random.default_rng(1)
        kv.append_tokens(0, tb(rng.normal(size=(10, 8)).astype(np.float32)))
        before = kv.gather(0).clone()
        kv.spill(0)
        kv.fetch(0)
        assert np.array_equal(kv.gather(0), before)
        assert kv.remote_base >= 2048 - 512   # arena lives in the heap slice


def test_kv_spill_cannot_corrupt_heap_buffers():
    """The KV arena is RESERVED from the heap: spills land in pages the
    heap can no longer hand out, a second store gets a disjoint arena,
    and exhausting the arena raises instead of walking out of it."""
    with box.open(small_spec(heap_pages=512), device="cpu") as session:
        heap = session.heap()
        buf = heap.alloc(4 * PAGE_SIZE)
        data = tb(np.arange(4 * PAGE_SIZE, dtype=np.uint8))
        buf.write(data).wait(10)
        kv = session.kv_store(num_pages=16, page_tokens=4, kv_features=8)
        kv2 = session.kv_store(num_pages=16, page_tokens=4, kv_features=8)
        assert kv2.remote_base >= kv.remote_base + 16   # disjoint arenas
        for store, seq in ((kv, 0), (kv2, 0)):
            store.add_sequence(seq)
            store.append_tokens(
                seq, torch.ones((16, 8), dtype=torch.float32) * (seq + 1))
            store.spill(seq, donor=buf.donor)
        assert np.array_equal(buf.read(), data), \
            "KV spill overwrote a live heap buffer"
        # arena exhaustion is loud, not silent corruption
        kv.fetch(0)
        with pytest.raises(box.AllocError, match="arena exhausted"):
            for _ in range(16):          # re-spills bump, never recycle
                kv.spill(0, donor=buf.donor)
                kv.fetch(0)


# ---- policy registries ----------------------------------------------------
def test_policies_selected_by_name():
    spec = small_spec(admission="congestion", polling="event_batch",
                      batching="doorbell")
    with box.open(spec, device="cpu") as session:
        from repro_torch.core import BatchPolicy, CongestionAwareHook, PollMode
        engine = session.engine()
        assert isinstance(engine.admission.hook, CongestionAwareHook)
        assert engine.cfg.poll.mode is PollMode.EVENT_BATCH
        assert engine.cfg.batch_policy is BatchPolicy.DOORBELL
    with pytest.raises(ValueError, match="unknown admission policy"):
        box.open(small_spec(admission="no-such-policy"), device="cpu")


def test_third_party_placement_registers_via_decorator():
    @box.register_policy("placement", "first-donor-only")
    class FirstDonorOnly:
        """Single replica, always on the first donor (test policy)."""

        def capacity_pages(self, ps):
            return ps.replica_region

        def replicas(self, ps, page_id):
            return [(ps.donors[0], ps.region_base + page_id)]

    assert "first-donor-only" in box.policy_names("placement")
    with box.open(small_spec(placement="first-donor-only"), device="cpu") as session:
        pager = session.pager()
        assert pager.replicas(3) == [(session.donors[0], 3)]
        pager.swap_out(3, PAGE, wait=True)
        assert np.array_equal(pager.swap_in(3), PAGE)


# ---- the one stats tree ---------------------------------------------------
def test_stats_tree_has_all_namespaces_populated():
    with box.open(small_spec(num_clients=2), device="cpu") as session:
        for i in range(2):
            session.pager(i).swap_out(0, PAGE, wait=True)
        session.heap().alloc(PAGE_SIZE)
        st = session.stats()
        assert set(st) >= {"fabric", "nic", "client", "paging"}
        assert st["fabric"]["faults"]["injected"] == 0
        assert st["fabric"]["service"], "donor-side service accounting empty"
        # every node (2 clients + 3 donors) has a NIC namespace
        assert set(st["nic"]) == {str(n) for n in range(5)}
        assert st["nic"]["0"]["wqes_posted"] > 0
        for i in ("0", "1"):
            assert st["client"][i]["box"]["merge"]["submitted"] > 0
            assert "admission" in st["client"][i]["box"]
        assert st["client"]["0"]["heap"]["live_buffers"] == 1
        assert st["paging"] == st["client"]["0"]["paging"]
        flat = session.stats(flat=True)
        assert flat["client.0.box.merge.submitted"] > 0
        assert any(k.startswith("nic.3.") for k in flat)


def test_flatten_stats_expands_list_leaves():
    """List leaves flatten to indexed dotted keys — per-worker and
    per-link stats are addressable, not opaque blobs."""
    from repro_torch.box.stats import flatten_stats

    tree = {"service": {"per_worker": [{"served_wqes": 3},
                                       {"served_wqes": 5}]},
            "links": [{"bytes": 7}],
            "empty": [],
            "tup": (1, 2),
            "scalar": 42}
    flat = flatten_stats(tree)
    assert flat["service.per_worker.0.served_wqes"] == 3
    assert flat["service.per_worker.1.served_wqes"] == 5
    assert flat["links.0.bytes"] == 7
    assert flat["empty"] == []          # empty lists stay leaves
    assert flat["tup.0"] == 1 and flat["tup.1"] == 2
    assert flat["scalar"] == 42
    # a real session's fabric link list expands too
    with box.open(small_spec(), device="cpu") as session:
        session.pager().swap_out(0, PAGE, wait=True)
        flat = session.stats(flat=True)
        assert any(k.startswith("fabric.links.0.") for k in flat), \
            [k for k in flat if k.startswith("fabric.links")]


# ---- ECN marks (satellite) ------------------------------------------------
def test_ecn_marks_shrink_window_without_latency_signal():
    """The link's congestion multiplier surfaces as an ECN-style mark on
    WorkCompletion, and CongestionAwareHook shrinks on marks even when
    the latency-EWMA condition can never fire (latency_factor=1e9)."""
    spec = small_spec(
        num_donors=1, replication=1, heap_pages=0,
        admission={"name": "congestion",
                   "params": {"latency_factor": 1e9, "calibration": 4,
                              "adjust_every": 4}})
    with box.open(spec, device="cpu") as session:
        pager = session.pager()
        hook = session.engine().admission.hook
        donor = session.donors[0]
        for pid in range(12):
            pager.swap_out(pid, PAGE, wait=True)
        assert hook.window_fraction == 1.0
        session.congest_path(session.clients[0], donor, 20.0)
        marked = []
        session.engine().write(donor, 100, PAGE,
                               callback=lambda wc: marked.append(wc.ecn_mult)
                               ).wait(10)
        assert marked and marked[0] > 1.0 and marked[0] == pytest.approx(20.0)
        for pid in range(16):
            pager.swap_out(pid, PAGE, wait=True)
        snap = hook.snapshot()
        assert snap["ecn_marks"] > 0
        assert hook.window_fraction < 1.0, \
            f"window never shrank on ECN marks alone: {snap}"
        session.clear_path(session.clients[0], donor)
        for pid in range(32):
            pager.swap_out(pid % 12, PAGE, wait=True)
        assert hook.window_fraction > snap["window_fraction"]


def test_ecn_insensitive_hook_ignores_marks():
    from repro_torch.core import CongestionAwareHook
    from repro_torch.core.descriptors import Verb, WorkCompletion
    hook = CongestionAwareHook(latency_factor=1e9, calibration=2,
                               adjust_every=2, ecn_sensitive=False)
    for i in range(20):
        hook.observe(WorkCompletion(wr_id=i, verb=Verb.WRITE, dest_node=1,
                                    nbytes=PAGE_SIZE, post_vtime_us=0.0,
                                    complete_vtime_us=10.0, ecn_mult=8.0))
    assert hook.window_fraction == 1.0
    assert hook.snapshot()["ecn_marks"] == 20


# ---- deprecation shims ----------------------------------------------------
def test_shims_warn_exactly_once():
    from repro_torch.memory import MemoryCluster, OffloadManager
    reset_deprecation("MemoryCluster")
    reset_deprecation("OffloadManager")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c1 = MemoryCluster(num_donors=2, donor_pages=512, device="cpu")
        c1.close()
        c2 = MemoryCluster(num_donors=2, donor_pages=512, device="cpu")
        OffloadManager(c2.paging)
        OffloadManager(c2.paging)
        c2.close()
    deps = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len([w for w in deps if "MemoryCluster" in str(w.message)]) == 1
    assert len([w for w in deps if "OffloadManager" in str(w.message)]) == 1


def test_shim_still_serves_the_legacy_surface():
    from repro_torch.memory import MemoryCluster
    with MemoryCluster(num_donors=2, donor_pages=1024, device="cpu") as c:
        c.paging.swap_out(1, PAGE, wait=True)
        assert np.array_equal(c.paging.swap_in(1), PAGE)
        st = c.stats()
        assert {"box", "paging", "fabric"} <= set(st)
        assert st["box"]["merge"]["submitted"] > 0


def test_session_never_warns_deprecation():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with box.open(small_spec(), device="cpu") as session:
            session.pager().swap_out(0, PAGE, wait=True)
            session.tensors()
            session.kv_store(num_pages=4, page_tokens=2, kv_features=4)
    assert not [w for w in caught
                if issubclass(w.category, DeprecationWarning)]


# ---- public-surface guard (CI satellite) ----------------------------------
# the reference's names minus ModelSession and ModelWorkload, which wait
# for the analytic backend (ROADMAP item 8(d))
EXPECTED_ALL = {
    "AllocError", "BatchFuture", "BatchTransferError", "BoxError",
    "ClosedError", "ClusterSpec", "KVStore", "PAGE_SIZE", "Pager",
    "PolicySpec", "RemoteBuffer",
    "RemoteHeap", "SLAClass", "Session", "TensorStore", "TransferError",
    "TransferFuture", "create_policy", "flatten_stats", "open",
    "policy_names", "register_policy",
}


def _public_api_section(path):
    section = re.search(r"## Public API\n(.*?)(?:\n## |\Z)",
                        path.read_text(), flags=re.S)
    assert section, f"{path.name} lost its 'Public API' section"
    return set(re.findall(r"`([A-Za-z_][A-Za-z0-9_.]*)`", section.group(1)))


def test_public_all_matches_documented_names():
    assert set(box.__all__) == EXPECTED_ALL
    for name in box.__all__:
        assert getattr(box, name) is not None
    # every public name appears in the README's Public API section AND
    # the docs tree's canonical list (docs/architecture.md)
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    for page in (root / "README.md", root / "docs" / "architecture.md"):
        documented = _public_api_section(page)
        missing = {n for n in EXPECTED_ALL
                   if n not in documented
                   and f"box.{n}" not in documented}
        assert not missing, \
            f"{page.name}: undocumented public names: {sorted(missing)}"



def test_open_refuses_the_model_backend():
    with pytest.raises(box.BoxError, match=r"ROADMAP item 8\(d\)"):
        box.open(small_spec(), backend="model", device="cpu")


def test_fabric_nic_and_legacy_box_need_a_gpu_unless_cpu_is_asked():
    from repro_torch.core.nic import SimulatedNIC
    from repro_torch.core.rdmabox import RDMABox
    from repro_torch.core.region import RegionDirectory, RemoteRegion
    from repro_torch.fabric import Fabric
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    directory = RegionDirectory()
    directory.register(RemoteRegion(1, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fabric()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimulatedNIC(0, directory)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RDMABox(0, directory, [1])
    with Fabric(device="cpu") as fab:
        assert fab.device == torch.device("cpu") and not fab.pin_memory
    nic = SimulatedNIC(0, directory, device="cpu")
    assert nic.device == torch.device("cpu")
    nic.close()


def test_open_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        box.open(small_spec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MemoryCluster(num_donors=2, donor_pages=512)
    with box.open(small_spec(), device="cpu") as session:
        assert session.device == torch.device("cpu")
        region = session.directory.lookup(session.donors[0])
        assert not region._mem.is_pinned()


def test_offload_keeps_dtype_and_shape_through_a_byte_view():
    """A bf16 leaf round-trips through a view of its bytes (never a cast
    of its values) and comes back with its dtype; a non-contiguous leaf
    too."""
    with box.open(small_spec(), device="cpu") as session:
        store = session.tensors()
        g = torch.Generator().manual_seed(0)
        tree = {"w": torch.randn(33, 70, generator=g).bfloat16(),
                "m": {"t": torch.randn(9, 4, generator=g).t(),
                      "i": torch.arange(-7, 1000, dtype=torch.int64)},
                "s": [torch.tensor(2.5, dtype=torch.float16)]}
        store.offload_tree("opt", tree, wait=True)
        back = store.fetch_tree("opt", tree)
        flat, back_flat = (torch.utils._pytree.tree_flatten(t)[0] for t in (tree, back))
        for a, b in zip(flat, back_flat):
            assert b.dtype == a.dtype and b.shape == a.shape
            assert torch.equal(b, a)


def test_swap_out_views_bytes_and_takes_exactly_one_page():
    with box.open(small_spec(), device="cpu") as session:
        pager = session.pager()
        page = torch.linspace(-3, 3, PAGE_SIZE // 4)         # f32: one page of bytes
        pager.swap_out(2, page, wait=True)
        assert torch.equal(pager.swap_in(2).view(torch.float32), page)
        for bad in (torch.zeros(PAGE_SIZE, dtype=torch.float32),   # 4 pages of bytes
                    torch.zeros(PAGE_SIZE - 1, dtype=torch.uint8)):
            with pytest.raises(ValueError, match="exactly one page"):
                pager.swap_out(3, bad)


# ===========================================================================
# twins of the gather, spill and offload cases of tests/test_kv_cache.py
# ===========================================================================

def test_gather_correctness_and_descriptor_reduction():
    reset_deprecation("PagedKVCache")
    with pytest.warns(DeprecationWarning):
        kv = PagedKVCache(num_pages=64, page_tokens=4, kv_features=8, device="cpu")
    rng = np.random.default_rng(0)
    data = tb(rng.normal(size=(30, 8)).astype(np.float32))
    kv.add_sequence(0)
    kv.append_tokens(0, data)
    out = kv.gather(0)
    np.testing.assert_array_equal(out, data)
    # sequential allocation ⇒ contiguous ⇒ 1 descriptor for 8 pages
    assert kv.gather_descriptors < kv.gather_pages or kv.gather_pages == 1


@pytest.mark.parametrize("features,dtype", [(128, torch.float32), (100, torch.float32),
                                            (64, torch.bfloat16)],
                         ids=["f32-whole-pages", "f32-padded", "bf16-padded"])
def test_spill_fetch_roundtrip(features, dtype):
    """Twin of test_spill_fetch_roundtrip (8 tokens × 128 f32 = one whole
    engine page a pool page), plus pool pages that are not a whole number
    of engine pages, which go through a padded copy."""
    with MemoryCluster(num_donors=2, donor_pages=1 << 14, device="cpu") as cluster:
        kv = PagedKVCache(num_pages=32, page_tokens=8,
                          kv_features=features, dtype=dtype, box=cluster.box)
        assert kv.pool.device == torch.device("cpu")
        assert bool(kv._pad) == (features != 128)
        rng = np.random.default_rng(1)
        data = tb(rng.normal(size=(40, features)).astype(np.float32))
        kv.add_sequence(7)
        kv.append_tokens(7, data)
        before = kv.gather(7).clone()
        kv.spill_sequence(7, cluster.donors[0])
        assert kv.alloc.free_count == 32 and kv.tables[7] == [-1] * 5
        kv.fetch_sequence(7, cluster.donors[0])
        after = kv.gather(7)
        assert after.dtype == dtype
        assert torch.equal(before.reshape(-1).view(torch.uint8),
                           after.reshape(-1).view(torch.uint8))


def test_offload_tree_roundtrip():
    with MemoryCluster(num_donors=3, donor_pages=1 << 14, device="cpu") as cluster:
        mgr = OffloadManager(cluster.paging)
        tree = {"a": torch.arange(1000, dtype=torch.float32).reshape(10, 100),
                "b": {"c": torch.ones((3, 7), dtype=torch.float32) * 2.5}}
        mgr.offload_tree("t", tree, wait=True)
        back = mgr.fetch_tree("t", tree)
        np.testing.assert_array_equal(back["a"], tree["a"])
        np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])


# ===========================================================================
# parity with repro: one spec, one op sequence, both packages
# ===========================================================================

ref_box = pytest.importorskip("repro.box")

PARITY_SPEC = dict(num_donors=3, donor_pages=2048, heap_pages=512, replication=2,
                   num_clients=2, nic_scale=2e-8,
                   link={"latency_us": 2.0, "gbps": 56.0},
                   faults=[{"kind": "slow", "node": 3, "factor": 2.0}],
                   sla=["premium", "best_effort"], admission="congestion",
                   mr_prefetch={"depth": 32})


def test_parity_spec_json_is_identical():
    mine, theirs = box.ClusterSpec(**PARITY_SPEC), ref_box.ClusterSpec(**PARITY_SPEC)
    assert mine.to_json() == theirs.to_json()
    assert box.ClusterSpec.from_json(theirs.to_json()) == mine
    assert mine.validate().to_dict() == theirs.validate().to_dict()


def _op_sequence(pkg, device_kw, as_buf, as_out):
    """heap alloc/write/read, pager swap_out/swap_in, kv_store
    add/append/spill/fetch — single-threaded; returns what came back."""
    rng = np.random.default_rng(17)
    heap_bytes = rng.integers(0, 256, 6 * PAGE_SIZE).astype(np.uint8)
    pages = [rng.integers(0, 256, PAGE_SIZE).astype(np.uint8) for _ in range(12)]
    rows = rng.normal(size=(3, 23, 16)).astype(np.float32)
    spec = pkg.ClusterSpec(**{**PARITY_SPEC, "faults": None, "sla": None,
                              "admission": "static"})
    with pkg.open(spec, **device_kw) as session:
        buf = session.heap().alloc(6 * PAGE_SIZE)
        buf.writev([(i, as_buf(heap_bytes[i * PAGE_SIZE:(i + 1) * PAGE_SIZE]))
                    for i in range(6)]).wait(10)
        heap_back = as_out(buf.read())
        part = as_out(buf.read(page_offset=2, num_pages=3))
        pager = session.pager()
        for pid, p in enumerate(pages):
            pager.swap_out(pid, as_buf(p), wait=True)
        swapped = [as_out(pager.swap_in(pid)) for pid in range(12)]
        kv = session.kv_store(num_pages=24, page_tokens=4, kv_features=16)
        for s in range(3):
            kv.add_sequence(s)
        for t in range(23):                 # interleaved: fragmented tables
            for s in range(3):
                kv.append_tokens(s, as_buf(rows[s, t : t + 1]))
        gathered = [as_out(kv.gather(s)) for s in range(3)]
        kv.spill(1)
        kv.spill(0)
        kv.fetch(1)
        kv.fetch(0)
        tables = {s: list(kv.tables[s]) for s in range(3)}
        fetched = [as_out(kv.gather(s)) for s in range(3)]
        flat = pkg.flatten_stats(session.stats())
    return dict(heap=heap_back, part=part, swapped=swapped, gathered=gathered,
                fetched=fetched, tables=tables, flat=flat,
                expect=(heap_bytes, pages, rows))


def test_parity_box_op_sequence():
    mine = _op_sequence(box, {"device": "cpu"}, tb, lambda t: t.numpy().copy())
    ref = _op_sequence(ref_box, {}, lambda a: a, lambda a: np.asarray(a).copy())
    heap_bytes, pages, rows = mine["expect"]
    for got in (mine, ref):
        np.testing.assert_array_equal(got["heap"], heap_bytes)
        np.testing.assert_array_equal(got["part"], heap_bytes[2 * PAGE_SIZE:5 * PAGE_SIZE])
        for pid, p in enumerate(pages):
            np.testing.assert_array_equal(got["swapped"][pid], p)
        for s in range(3):
            np.testing.assert_array_equal(got["gathered"][s], rows[s])
            np.testing.assert_array_equal(got["fetched"][s], rows[s])
    assert mine["tables"] == ref["tables"]
    assert set(mine["flat"]) == set(ref["flat"])
    # deterministic counters: requests submitted, pages served by the
    # donors (written + read, whatever the merging), the KV gathers
    counters = [k for k in mine["flat"] if k.endswith(".merge.submitted")
                or re.fullmatch(r"fabric\.service\.\d+\.\d+\.bytes", k)
                or k.startswith("kv.")]
    assert len(counters) >= 8
    for k in counters:
        assert mine["flat"][k] == ref["flat"][k], k


# ===========================================================================
# on the card (skip here): CUDA client buffers, stream-ordered spills
# ===========================================================================

def test_gpu_heap_and_kv_store_round_trip_cuda_buffers():
    dev = cuda_or_skip()
    with box.open(small_spec(heap_pages=512), device=dev) as session:
        region = session.directory.lookup(session.donors[0])
        assert region._mem.device.type == "cpu" and region._mem.is_pinned()
        g = torch.Generator(device=dev).manual_seed(0)
        data = torch.randint(0, 256, (6 * PAGE_SIZE,), generator=g, device=dev,
                             dtype=torch.uint8)
        buf = session.heap().alloc(6 * PAGE_SIZE)
        buf.writev([(i, data[i * PAGE_SIZE:(i + 1) * PAGE_SIZE]) for i in range(6)]).wait(10)
        back = buf.read()
        assert back.is_cuda and torch.equal(back, data)
        out = torch.empty(2 * PAGE_SIZE, dtype=torch.uint8, device=dev)
        buf.read_into(out, page_offset=3).wait(10)
        assert torch.equal(out, data[3 * PAGE_SIZE:5 * PAGE_SIZE])
        pager = session.pager()
        pager.swap_out(4, data[:PAGE_SIZE], wait=True)
        page = pager.swap_in(4)
        assert page.is_cuda and torch.equal(page, data[:PAGE_SIZE])
        kv = session.kv_store(num_pages=32, page_tokens=4, kv_features=64,
                              dtype=torch.bfloat16)
        assert kv.pool.is_cuda
        for s in range(2):
            kv.add_sequence(s)
            kv.append_tokens(s, torch.randn(37, 64, generator=g, device=dev))
        before = [kv.gather(s).clone() for s in range(2)]
        kv.spill(0)
        kv.spill(1)
        kv.fetch(1)
        kv.fetch(0)
        for s in range(2):
            assert torch.equal(kv.gather(s).view(torch.int16), before[s].view(torch.int16))


def test_gpu_spill_reads_what_a_kernel_just_wrote():
    """The pool is written by kernels queued behind a long matmul on the
    caller's stream and spilled with no synchronize in between: the
    engine's copies run on their own stream, ordered after the submit's
    event, so the donor must hold the written bytes, not the old ones."""
    dev = cuda_or_skip()
    with box.open(small_spec(heap_pages=1024), device=dev) as session:
        kv = session.kv_store(num_pages=16, page_tokens=16, kv_features=256,
                              dtype=torch.float32)          # 16 KB a pool page
        kv.add_sequence(0, 16 * 16)
        torch.cuda.synchronize()
        big = torch.randn(4096, 4096, device=dev)
        for _ in range(8):
            big = big @ big.T / 4096                     # keeps the stream busy
        # 3.5 everywhere, computed from the matmuls' result, so after them
        written = torch.full_like(kv.pool, 3.5) + (big[0, 0] == float("inf"))
        kv.pool.copy_(written)
        pages = list(kv.tables[0])
        kv.spill(0)                                      # no synchronize
        donor = kv._seq_donor[0]
        region = session.directory.lookup(donor)
        base = kv.remote_base
        got = region._mem[base: base + 16 * kv._rdma_pages].reshape(-1)
        want = written[pages].reshape(-1).view(torch.uint8).cpu()
        assert torch.equal(got, want)
