"""repro_torch.model, the analytic ``backend="model"``, against the reference.

Twins of ``tests/test_model.py`` on ``repro_torch`` with ``device="cpu"``,
at the reference's assertions and bounds, and of
``tests/test_mr_prefetch.py::test_model_prefetch_fault_rate_within_calibration_band``.
``test_open_dispatches_on_backend``'s twin is in ``tests/test_torch_box.py``.
``test_calibration_matches_threaded_engine_within_band`` has no twin here:
its band is a wall-clock measurement that fails under parallel test
workers on a shared host, so ``chip_smoke.py`` holds it on the card (the
``model`` phase) and ``test_calibration_plumbing_is_deterministic`` covers
``run_calibration``'s plumbing in its place.

Then parity cases: the same specs and workloads through
``repro.model.evaluate`` and ``repro_torch.model.evaluate`` give the same
report, field by field (``eval_ms``, a wall time, excepted), and the same
flat stats. The reference is imported inside the tests.
"""

import dataclasses
import math
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small buffers; leave the cores to parallel test workers

from repro_torch import box  # noqa: E402
from repro_torch.core import PAGE_SIZE  # noqa: E402
from repro_torch.model import (  # noqa: E402
    Center,
    ModelWorkload,
    erlang_c,
    evaluate,
    harmonic,
    run_calibration,
    zipf_top_share,
)

CPU = {"device": "cpu"}

# one PU-heavy, coarse-grained cost model for every analytic test that
# wants the donor side to dominate (mirrors bench_donor_scaling)
PU_HEAVY = {"num_pus": 8, "wqe_proc_us": 10.0, "wire_us_per_page": 2.0,
            "mmio_us": 0.05, "completion_dma_us": 0.1,
            "reg_kernel_us": 0.05}


def model_spec(**kw):
    base = dict(num_donors=4, num_clients=16, donor_pages=16384,
                replication=1, serve_workers=1, nic_cost=dict(PU_HEAVY),
                backend="model")
    base.update(kw)
    return box.ClusterSpec(**base)


# ---- spec field + dispatch ------------------------------------------------
def test_backend_field_round_trips_and_validates():
    spec = box.ClusterSpec(backend="model")
    assert box.ClusterSpec.from_json(spec.to_json()).backend == "model"
    assert box.ClusterSpec().backend == "sim"
    with pytest.raises(ValueError, match="unknown backend"):
        box.ClusterSpec(backend="emulator").validate()


def test_unknown_backend_raises_typed_error_listing_backends():
    with pytest.raises(box.BoxError, match="'sim'.*'model'"):
        box.open({}, backend="quantum", **CPU)


def test_model_backend_rejects_imperative_escape_hatches():
    for hatch in ("fault_plan", "admission_hook_factory", "app_handler",
                  "box_config", "disk"):
        with pytest.raises(box.BoxError, match=hatch):
            box.open(model_spec(), **{hatch: object()}, **CPU)


def test_sim_backend_rejects_workload_argument():
    with pytest.raises(box.BoxError, match="workload"):
        box.open({}, workload=box.ModelWorkload(), **CPU)


def test_imperative_accessors_raise_on_model_session():
    with box.open(model_spec(), **CPU) as s:
        for name in ("engine", "heap", "pager", "tensors", "crash_donor",
                     "congest_path"):
            with pytest.raises(box.BoxError, match="model backend"):
                getattr(s, name)()
    # closed sessions guard stats like the sim Session does
    with pytest.raises(box.BoxError, match="closed"):
        s.stats()


def test_declarative_faults_become_a_warning_not_an_error():
    spec = model_spec(faults=[{"kind": "slow", "node": 2, "factor": 9.0}])
    with box.open(spec, **CPU) as s:
        notes = s.stats()["model"]["warnings"]["notes"]
        assert any("fault" in n for n in notes), notes


def test_model_session_starts_no_thread_and_allocates_no_tensor():
    """``backend="model"`` never builds the threaded ``Session``: no NIC,
    poller or worker thread, and no donor memory."""
    before = threading.active_count()
    with box.open(model_spec(num_clients=500, num_donors=64,
                             donor_pages=1 << 16), **CPU) as s:
        assert isinstance(s, box.ModelSession)
        assert threading.active_count() == before
        s.sweep([{"serve_workers": w} for w in (1, 8)])
        assert threading.active_count() == before
        assert not any(isinstance(v, torch.Tensor) for v in vars(s).values())


def test_model_backend_resolves_the_device_like_the_sim_backend():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    for backend in ("model", "sim"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            box.open(model_spec(backend=backend))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_calibration(box.ClusterSpec(),
                        ModelWorkload(client_ops_per_s=100.0))


# ---- stats-tree namespaces ------------------------------------------------
def test_stats_reuses_sim_namespaces():
    wl = ModelWorkload(client_ops_per_s=1000.0)
    spec = model_spec(num_clients=2, num_donors=2, sla="standard")
    with box.open(spec, workload=wl, **CPU) as s:
        st = s.stats()
        donor = str(s.donors[0])
        svc = st["nic"][donor]["service"]
        assert svc["serve_workers"] == 1
        lat = svc["per_class"]["standard"]["latency"]
        # histogram-shaped leaves: estimates carry count=0
        assert set(lat) == {"count", "mean_us", "p50_us", "p99_us",
                            "p999_us", "max_us"}
        assert lat["count"] == 0
        assert 0 < lat["p50_us"] <= lat["p99_us"] <= lat["p999_us"]
        box_lat = st["client"]["0"]["box"]["latency"]
        assert box_lat["p99_us"] == lat["p99_us"]
        assert st["client"]["0"]["box"]["sla_class"] == "standard"
        flat = s.stats(flat=True)
        assert flat[f"nic.{donor}.service.per_class.standard.latency."
                    "p99_us"] > 0
        assert flat["client.1.box.latency.mean_us"] > 0
        assert flat["model.bottleneck"]
        assert flat["model.capacity_ops_per_s"] > 0
        assert any(k.startswith("model.centers.donor.ingress_pu.")
                   for k in flat)
    # the port's own sim session, once every client has written to every
    # donor, carries each histogram, worker and hit-rate key the model fills
    with box.open(spec, backend="sim", nic_scale=2e-8, **CPU) as sim:
        page = torch.zeros(PAGE_SIZE, dtype=torch.uint8)
        for i in range(spec.num_clients):
            for d in sim.donors:
                sim.engine(i).write(d, i, page).wait(10)
        sim_flat = sim.stats(flat=True)
    estimates_only = ("ops_per_s", "bytes_per_s", "prefetch_coverage",
                      "sla_class")
    shared = [k for k in flat if not k.startswith("model.")
              and not k.endswith(estimates_only)]
    assert len(shared) == 2 * 9 + 2 * 6     # per donor, per client
    assert [k for k in shared if k not in sim_flat] == []


# ---- center math ----------------------------------------------------------
def test_erlang_c_limits():
    assert erlang_c(1, 0.0) == 0.0
    # M/M/1: P(wait) == rho
    assert erlang_c(1, 0.6) == pytest.approx(0.6)
    # pooling lowers the delay probability at the same per-server rho
    assert erlang_c(8, 8 * 0.6) < erlang_c(2, 2 * 0.6) < 0.6


def test_harmonic_matches_brute_force_above_cutoff():
    for s in (0.0, 0.7, 1.0, 1.3):
        brute = sum(k ** -s for k in range(1, 20_001))
        assert harmonic(20_000, s) == pytest.approx(brute, rel=1e-6)


def test_zipf_top_share_sanity():
    assert zipf_top_share(1000, 100, 0.0) == pytest.approx(0.1)
    assert zipf_top_share(1000, 1000, 1.2) == pytest.approx(1.0)
    assert zipf_top_share(0, 10, 1.0) == 0.0
    # skew concentrates traffic on the top; share grows with skew
    uniform = zipf_top_share(1 << 20, 1 << 10, 0.0)
    skewed = zipf_top_share(1 << 20, 1 << 10, 1.1)
    assert skewed > 10 * uniform


def test_slo_weights_redistribute_waits_conserving_total():
    c = Center(name="x", servers=1)
    c.add_visits("premium", 0.004, 100.0, weight=4.0)
    c.add_visits("best_effort", 0.004, 100.0, weight=1.0)
    c.solve()
    wp, wb = c.wait_us("premium"), c.wait_us("best_effort")
    assert 0 < wp < wb
    base = c.solve().queue_us
    total_rate = 0.008
    assert 0.004 * wp + 0.004 * wb == pytest.approx(total_rate * base)


def test_cache_hit_rate_feeds_region_bandwidth():
    hot = model_spec(donor_cache_pages=1024)
    wl = ModelWorkload(read_fraction=1.0, zipf_s=1.1,
                       working_set_pages=16384)
    hit = evaluate(hot, wl)
    miss = evaluate(model_spec(), wl)
    assert hit.cache_hit_rate > 0.5
    assert miss.cache_hit_rate == 0.0
    # hits bypass region bandwidth: same offered rate, lower utilization
    rate = hit.workload.client_ops_per_s
    miss_at_same = evaluate(model_spec(), wl.with_rate(rate))
    assert (hit.centers["donor.region_bw"].utilization
            < miss_at_same.centers["donor.region_bw"].utilization)


def test_mr_faults_inflate_mean_and_tail():
    wl = ModelWorkload(client_ops_per_s=1000.0, zipf_s=0.0,
                       working_set_pages=16384)
    cold = evaluate(model_spec(registered_pages=64), wl)
    warm = evaluate(model_spec(), wl)
    cls_cold = cold.classes["default"]
    cls_warm = warm.classes["default"]
    assert cls_cold.mr_fault_rate > 0.9
    assert cls_warm.mr_fault_rate == 0.0
    assert cls_cold.mean_us > cls_warm.mean_us
    assert cls_cold.p99_us > cls_warm.p99_us


def test_prefetch_coverage_scales_down_the_fault_rate():
    """``stride_fraction`` of the traffic is predictable; with MR
    prefetch enabled that fraction's faults move off the critical path:
    the effective fault rate is ``fault_raw * (1 - coverage)``, the tail
    shrinks, and the covered registrations still load the donor PU."""
    wl = ModelWorkload(client_ops_per_s=1000.0, zipf_s=0.0,
                       working_set_pages=16384, stride_fraction=0.75)
    off = evaluate(model_spec(registered_pages=64), wl)
    on = evaluate(model_spec(registered_pages=64,
                             mr_prefetch={"depth": 8}), wl)
    assert off.mr_prefetch_coverage == 0.0
    assert on.mr_prefetch_coverage == 0.75
    raw = off.classes["default"].mr_fault_rate
    assert on.classes["default"].mr_fault_rate == pytest.approx(0.25 * raw)
    assert on.classes["default"].mean_us < off.classes["default"].mean_us
    # a near-fully-covered stream pushes faults below the 1% tail
    # threshold: the registration stall leaves p99 entirely
    hi = evaluate(model_spec(registered_pages=64, mr_prefetch={"depth": 8}),
                  ModelWorkload(client_ops_per_s=1000.0, zipf_s=0.0,
                                working_set_pages=16384,
                                stride_fraction=0.995))
    assert hi.classes["default"].mr_fault_rate < 0.01
    assert hi.classes["default"].p99_us < off.classes["default"].p99_us
    # background registrations are load, not latency: the covered run
    # works the donor PU harder than a fully-warm (no-fault) run, but
    # less than prefetch-off (covered faults also stop replaying the
    # whole WQE through the donor)
    warm = evaluate(model_spec(), wl)
    assert (warm.centers["donor.ingress_pu"].utilization
            < on.centers["donor.ingress_pu"].utilization
            < off.centers["donor.ingress_pu"].utilization)


def test_prefetch_coverage_requires_depth_and_a_cache():
    wl = ModelWorkload(client_ops_per_s=1000.0, stride_fraction=1.0,
                       working_set_pages=16384)
    # no prefetch knob: stride_fraction alone changes nothing
    rep = evaluate(model_spec(registered_pages=64), wl)
    assert rep.mr_prefetch_coverage == 0.0
    assert rep.classes["default"].mr_fault_rate > 0.9
    # depth 0 is explicit off; no MR cache means nothing to cover
    assert evaluate(model_spec(registered_pages=64,
                               mr_prefetch={"depth": 0}),
                    wl).mr_prefetch_coverage == 0.0
    assert evaluate(model_spec(mr_prefetch={"depth": 8}),
                    wl).mr_prefetch_coverage == 0.0
    # the policy's own knob works without the spec override
    rep = evaluate(model_spec(
        mr={"name": "lru", "params": {"capacity_pages": 64,
                                      "prefetch_depth": 4}}), wl)
    assert rep.mr_prefetch_coverage == 1.0


def test_stride_fraction_validates():
    with pytest.raises(ValueError, match="stride_fraction"):
        ModelWorkload(stride_fraction=1.5).validate()
    with pytest.raises(ValueError, match="stride_fraction"):
        ModelWorkload(stride_fraction=-0.1).validate()


def test_wqe_cache_thrash_penalty_is_charged():
    """Outstanding WQEs beyond the on-NIC cache refetch from host memory
    (Fig. 1) — the model charges the overflow fraction as extra egress
    serialization instead of the old note-only warning."""
    wl = ModelWorkload(client_ops_per_s=50_000.0)
    small = model_spec(nic_cost={**PU_HEAVY, "wqe_cache_entries": 1,
                                 "cache_miss_us": 50.0})
    big = model_spec(nic_cost={**PU_HEAVY, "wqe_cache_entries": 1 << 20,
                               "cache_miss_us": 50.0})
    thrashed = evaluate(small, wl)
    clean = evaluate(big, wl)
    notes = [n for n in thrashed.warnings["notes"] if "WQE cache" in n]
    assert notes and "refetch penalty" in notes[0]
    assert "exclude" not in notes[0]         # charged, not disclaimed
    assert not any("WQE cache" in n for n in clean.warnings["notes"])
    assert (thrashed.classes["default"].mean_us
            > clean.classes["default"].mean_us)
    assert (thrashed.centers["client.default.wire"].utilization
            > clean.centers["client.default.wire"].utilization)


# ---- saturation + bottleneck movement -------------------------------------
def test_overload_warns_saturated_and_stays_finite():
    rep = evaluate(model_spec(), ModelWorkload(client_ops_per_s=10e6))
    assert rep.saturated
    assert rep.bottleneck in rep.warnings["saturated"]
    cls = rep.classes["default"]
    assert cls.achieved_ops_per_s < cls.offered_ops_per_s
    for est in rep.centers.values():
        assert est.queue_us < float("inf")


def test_default_operating_point_is_below_saturation():
    rep = evaluate(model_spec(), ModelWorkload(target_utilization=0.8))
    assert not rep.saturated
    rhos = [e.utilization for e in rep.centers.values()]
    assert max(rhos) == pytest.approx(0.8, rel=1e-6)


def test_bottleneck_moves_from_ingress_pu_to_region_bw_with_workers():
    spec = model_spec(num_clients=500, num_donors=64, donor_pages=1 << 16)
    bottlenecks = {}
    for w in (1, 2, 4, 8):
        rep = evaluate(box.ClusterSpec(**{**spec.to_dict(),
                                          "serve_workers": w}))
        bottlenecks[w] = rep.bottleneck
    assert bottlenecks[1] == "donor.ingress_pu"
    assert bottlenecks[8] == "donor.region_bw"


# ---- sweep ----------------------------------------------------------------
def test_sweep_returns_per_variant_summaries_fast():
    with box.open(model_spec(), **CPU) as s:
        rows = s.sweep([{"serve_workers": w} for w in (1, 2, 4, 8)])
        assert len(rows) == 4
        caps = [r["capacity_ops_per_s"] for r in rows]
        assert caps == sorted(caps) and caps[-1] > caps[0]
        assert all(r["eval_ms"] < 100.0 for r in rows)
        assert {r["bottleneck"] for r in rows} >= {"donor.ingress_pu"}
        for r in rows:
            assert "p99_us" in r["classes"]["default"]


# ---- calibration ----------------------------------------------------------
# the reference's calibration point (tests/test_model.py)
CALIBRATION_SPEC = dict(
    num_donors=2, num_clients=4, donor_pages=4096, replication=1,
    serve_workers=1, nic_scale=4e-6, admission="congestion",
    nic_cost={"wqe_proc_us": 400.0, "wire_us_per_page": 5.0,
              "mmio_us": 0.3, "completion_dma_us": 0.5,
              "reg_kernel_us": 0.12, "dma_read_us": 0.5})
CALIBRATION_WORKLOAD = dict(client_ops_per_s=500.0, read_fraction=0.0,
                            pages_per_op=1)


def test_calibration_plumbing_is_deterministic():
    """``run_calibration`` on CPU buffers: its model side is ``evaluate``
    of both packages at the same point, no op fails, and every number is
    finite. The measured side's agreement band is wall-clock-bound and is
    held on the card by ``chip_smoke.py``."""
    from repro import box as ref_box
    from repro.model import evaluate as ref_evaluate
    spec = box.ClusterSpec(**CALIBRATION_SPEC)
    wl = ModelWorkload(**CALIBRATION_WORKLOAD)
    before = threading.active_count()
    result = run_calibration(spec, wl, ops_per_client=8, device="cpu")
    assert threading.active_count() == before     # the session shut down
    for rep in (evaluate(spec, wl),
                ref_evaluate(ref_box.ClusterSpec(**CALIBRATION_SPEC),
                             ref_box.ModelWorkload(**CALIBRATION_WORKLOAD))):
        cls = rep.classes["default"]
        assert result.model_ops_per_s == cls.achieved_ops_per_s
        assert result.model_mean_us == cls.mean_us
        assert result.model_p99_us == cls.p99_us
        assert result.model_saturated == rep.saturated
        assert report_fields(result.report) == report_fields(rep)
    assert result.offered_ops_per_s == 500.0
    assert not result.model_saturated
    for f in dataclasses.fields(result):
        if f.name != "report":
            assert math.isfinite(getattr(result, f.name)), f.name
    assert result.measured_ops_per_s > 0 and result.measured_mean_us > 0
    assert result.measured_p99_us > 0
    assert "throughput model/measured=" in result.agreement()


def test_calibration_counts_every_op_and_no_failure(monkeypatch):
    """The session ``run_calibration`` drives sees exactly
    ``ops_per_client`` writes from each client and no failed completion."""
    from repro_torch.box import session as session_mod
    seen = {}

    class Recording(session_mod.Session):
        def stats(self, flat=False):
            st = super().stats(flat)
            seen.update(st)
            return st

    monkeypatch.setattr(session_mod, "Session", Recording)
    run_calibration(box.ClusterSpec(**CALIBRATION_SPEC),
                    ModelWorkload(**CALIBRATION_WORKLOAD),
                    ops_per_client=8, device="cpu")
    for i in range(4):
        client = seen["client"][str(i)]["box"]
        assert client["latency"]["count"] == 8
        assert client["merge"]["submitted"] == 8
    assert sum(nic["wc_errors"] for nic in seen["nic"].values()) == 0


def test_calibration_requires_an_explicit_rate():
    with pytest.raises(ValueError, match="client_ops_per_s"):
        run_calibration(box.ClusterSpec(), ModelWorkload())


# ---- twin of tests/test_mr_prefetch.py's model case -------------------------
def _mr_stats(session, donor):
    return session.stats()["nic"][str(donor)]["service"]["mr"]


def _strided_sim_fault_rate(prefetch, ops=128, stride=2):
    spec = box.ClusterSpec(num_donors=1, donor_pages=512, replication=1,
                           nic_scale=2e-8, registered_pages=16,
                           serve_workers=2, rnr_backoff_us=10.0,
                           mr_prefetch=prefetch)
    with box.open(spec, **CPU) as s:
        donor = s.donors[0]
        eng = s.engine(0)
        out = torch.empty(PAGE_SIZE, dtype=torch.uint8)
        for k in range(ops):
            eng.read(donor, k * stride, 1, out=out).wait(30)
            time.sleep(0.002)
        return _mr_stats(s, donor)["faults"] / ops


def test_model_prefetch_fault_rate_within_calibration_band():
    """A stride-2 scan over 128 distinct pages with 16 registered: the
    simulator faults on ~every touch with prefetch off and almost never
    with it on; the analytic fault-rate prediction (zipf share, times
    ``1 - stride_fraction`` coverage when prefetch is enabled) must land
    within the same ±35% band the backend promises elsewhere."""
    ops = 128
    base = dict(num_donors=1, donor_pages=512, replication=1,
                registered_pages=16, serve_workers=2)
    wl = ModelWorkload(client_ops_per_s=1000.0, read_fraction=1.0,
                       working_set_pages=ops, stride_fraction=1.0)
    sim_off = _strided_sim_fault_rate(None, ops=ops)
    model_off = evaluate(box.ClusterSpec(**base),
                         wl).classes["default"].mr_fault_rate
    assert sim_off > 0.9
    assert abs(model_off - sim_off) <= 0.35 * sim_off
    sim_on = _strided_sim_fault_rate(
        {"depth": 8, "degree": 4, "confidence": 2}, ops=ops)
    rep = evaluate(box.ClusterSpec(**base, mr_prefetch={"depth": 8}), wl)
    model_on = rep.classes["default"].mr_fault_rate
    assert rep.mr_prefetch_coverage == 1.0
    assert model_on == 0.0
    assert sim_on < sim_off / 2                  # prefetch worked in sim
    assert abs(model_on - sim_on) <= 0.35


# ===========================================================================
# parity with repro.model: one spec, one workload, both packages
# ===========================================================================

# floats agree to this relative error (the two packages run the same
# closed-form arithmetic, so in practice they agree bit for bit)
PARITY_REL = 1e-12

PARITY_CASES = {
    "default_target_utilization": (dict(), dict()),
    "sla_standard": (dict(num_clients=2, num_donors=2, sla="standard"),
                     dict(client_ops_per_s=1000.0)),
    "slo_classes": (dict(num_clients=6, service="slo",
                         sla=["premium", "premium", "standard", "standard",
                              "best_effort", "best_effort"]),
                    dict(client_ops_per_s=20_000.0, read_fraction=0.7)),
    "hot_cache_zipf": (dict(donor_cache_pages=1024),
                       dict(read_fraction=1.0, zipf_s=1.1,
                            working_set_pages=16384)),
    "mr_cold": (dict(registered_pages=64),
                dict(client_ops_per_s=1000.0, zipf_s=0.0,
                     working_set_pages=16384)),
    "mr_prefetch": (dict(registered_pages=64, mr_prefetch={"depth": 8}),
                    dict(client_ops_per_s=1000.0, zipf_s=0.0,
                         working_set_pages=16384, stride_fraction=0.75)),
    "mr_policy_prefetch": (dict(mr={"name": "lru", "params": {
                               "capacity_pages": 64, "prefetch_depth": 4}}),
                           dict(client_ops_per_s=1000.0, stride_fraction=1.0,
                                working_set_pages=16384)),
    "wqe_cache_thrash": (dict(nic_cost={**PU_HEAVY, "wqe_cache_entries": 1,
                                        "cache_miss_us": 50.0}),
                         dict(client_ops_per_s=50_000.0)),
    "write_through_disk": (dict(write_through_disk=True, replication=2),
                           dict(client_ops_per_s=2000.0, read_fraction=0.3,
                                replicate_writes=True)),
    "replication_2": (dict(replication=2),
                      dict(client_ops_per_s=5000.0, read_fraction=0.5,
                           replicate_writes=True, pages_per_op=4)),
    "link_spec": (dict(link={"latency_us": 5.0, "gbps": 56.0}),
                  dict(client_ops_per_s=4000.0)),
    "link_config_hatch": (dict(), dict(client_ops_per_s=4000.0)),
    "overloaded": (dict(), dict(client_ops_per_s=10e6)),
    "faults_declared": (dict(faults=[{"kind": "slow", "node": 2,
                                      "factor": 9.0}]),
                        dict(client_ops_per_s=1000.0)),
    "reg_mode_auto_user": (dict(reg_mode="auto", kernel_space=False),
                           dict(client_ops_per_s=3000.0, pages_per_op=8)),
    "reg_mode_dyn_mr": (dict(reg_mode="dynMR"),
                        dict(client_ops_per_s=3000.0, pages_per_op=2)),
    "cluster_500x64_w4": (dict(num_clients=500, num_donors=64,
                               donor_pages=1 << 16, serve_workers=4), dict()),
    "capacity_plan_point": (dict(num_clients=500, num_donors=16,
                                 donor_pages=1 << 16, sla="premium",
                                 service="slo", serve_workers=4,
                                 nic_cost={"num_pus": 8, "wqe_proc_us": 10.0,
                                           "wire_us_per_page": 2.0}),
                            dict(client_ops_per_s=8_000.0,
                                 read_fraction=0.7)),
}

LINK = dict(latency_us=3.0, gbps=25.0)


def _spec_dict(overrides):
    return {**dict(num_donors=4, num_clients=16, donor_pages=16384,
                   replication=1, serve_workers=1,
                   nic_cost=dict(PU_HEAVY), backend="model"), **overrides}


def report_fields(rep):
    """A report as plain data, its wall-clock ``eval_ms`` dropped."""
    out = dataclasses.asdict(rep)
    out.pop("eval_ms")
    return out


def assert_same(a, b, path="report"):
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, \
        (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not (math.isnan(a) and math.isnan(b)):
        assert a == b or math.isclose(a, b, rel_tol=PARITY_REL), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _both(case):
    from repro import box as ref_box
    from repro.fabric import LinkConfig as RefLinkConfig
    from repro.model import evaluate as ref_evaluate
    from repro_torch.fabric import LinkConfig
    overrides, workload = PARITY_CASES[case]
    hatch = case == "link_config_hatch"
    mine = evaluate(box.ClusterSpec(**_spec_dict(overrides)),
                    ModelWorkload(**workload),
                    link_config=LinkConfig(**LINK) if hatch else None)
    theirs = ref_evaluate(ref_box.ClusterSpec(**_spec_dict(overrides)),
                          ref_box.ModelWorkload(**workload),
                          link_config=RefLinkConfig(**LINK) if hatch else None)
    return mine, theirs


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_parity_evaluate(case):
    mine, theirs = _both(case)
    assert_same(report_fields(mine), report_fields(theirs))
    assert mine.saturated == theirs.saturated
    if case == "overloaded":
        assert mine.saturated
    if case == "link_config_hatch":       # the hatch changed the answer
        plain, _ = _both("link_spec")
        assert (mine.classes["default"].mean_us
                != plain.classes["default"].mean_us)


@pytest.mark.parametrize("case", ["sla_standard", "slo_classes",
                                  "mr_prefetch", "link_config_hatch"])
def test_parity_model_session_flat_stats(case):
    from repro import box as ref_box
    from repro.fabric import LinkConfig as RefLinkConfig
    from repro_torch.fabric import LinkConfig
    overrides, workload = PARITY_CASES[case]
    hatch = case == "link_config_hatch"
    with box.open(_spec_dict(overrides),
                  workload=ModelWorkload(**workload),
                  **({"link_config": LinkConfig(**LINK)} if hatch else {}),
                  **CPU) as s:
        mine = s.stats(flat=True)
        mine_rows = s.sweep([{"serve_workers": w} for w in (1, 4)])
    with ref_box.open(_spec_dict(overrides),
                      workload=ref_box.ModelWorkload(**workload),
                      **({"link_config": RefLinkConfig(**LINK)}
                         if hatch else {})) as s:
        theirs = s.stats(flat=True)
        their_rows = s.sweep([{"serve_workers": w} for w in (1, 4)])
    assert list(mine) == list(theirs)
    mine.pop("model.eval_ms")
    theirs.pop("model.eval_ms")
    assert_same(mine, theirs, "stats")
    for row in mine_rows + their_rows:
        row.pop("eval_ms")
    assert_same(mine_rows, their_rows, "sweep")
