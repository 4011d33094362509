"""repro_torch.examples: the twins of the reference's ``examples/``.

Each twin's ``main([..., "--device", "cpu"])`` runs here and prints its
closing line. Where the example's output is deterministic it is held to
the reference's, run in the same process: ``capacity_plan``'s printed
lines, and ``remote_paging_demo``'s hit, fault and eviction counts (the
same numpy access sequence drives both).
"""

import pathlib
import re
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small buffers; leave the cores to parallel test workers

from repro_torch.examples import (  # noqa: E402
    capacity_plan,
    quickstart,
    remote_paging_demo,
    serve_paged,
)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
CPU = ["--device", "cpu"]


def run_reference(monkeypatch, capsys, name, *args):
    """The reference example as a script, in this process; its stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [str(EXAMPLES / name), *args])
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    return capsys.readouterr().out


def test_quickstart_twin_prints_ok(capsys):
    res = quickstart.main(CPU)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("QUICKSTART OK")
    assert "1. alloc/write/read roundtrip OK (4 pages" in out
    assert "3. donor" in out and "replica read OK" in out
    # the burst merged: fewer RDMA ops than requests
    assert 0 < res["rdma_ops"] < res["submitted"]


PAGING_LINE = re.compile(r"(\d+) accesses: (\d+) hits, (\d+) faults, "
                         r"(\d+) evictions")
READABLE_LINE = re.compile(r"after donor-0 failure: (\d+) swapped pages")


def test_remote_paging_demo_counts_equal_the_reference(monkeypatch, capsys):
    res = remote_paging_demo.main(CPU)
    mine = capsys.readouterr().out
    assert mine.rstrip().endswith("REMOTE PAGING DEMO OK")
    theirs = run_reference(monkeypatch, capsys, "remote_paging_demo.py")
    assert theirs.rstrip().endswith("REMOTE PAGING DEMO OK")
    m, t = PAGING_LINE.search(mine), PAGING_LINE.search(theirs)
    assert m.groups() == t.groups()
    assert (res["hits"], res["faults"], res["evictions"]) == tuple(
        int(g) for g in t.groups()[1:])
    assert res["faults"] > 0 and res["evictions"] > 0
    assert (READABLE_LINE.search(mine).group(1)
            == READABLE_LINE.search(theirs).group(1)
            == str(res["readable_after_failure"]))


def test_serve_paged_twin_serves_and_spills(capsys):
    res = serve_paged.main(CPU)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("SERVING DONE")
    assert "spill/fetch:" in out
    logits = res.decode_logits
    assert logits.shape[:2] == (4, 24) and torch.isfinite(logits).all()
    assert res.spill is not None
    assert torch.equal(res.spill.kv.gather(0), res.spill.seq0_before)


def test_capacity_plan_prints_the_reference_lines(monkeypatch, capsys):
    res = capacity_plan.main(CPU)
    mine = capsys.readouterr().out
    theirs = run_reference(monkeypatch, capsys, "capacity_plan.py")
    assert mine.splitlines() == theirs.splitlines()
    assert (res["best"], res["cost"]) == (
        {"num_donors": 16, "serve_workers": 4}, 68)
    assert ("cheapest plan meeting the premium p99 target: 16 donors x 4 "
            "workers (cost 68, predicted p99 35.9us <= 60.0us)") in mine
    assert len(res["rows"]) == 12


def test_capacity_plan_reads_a_saved_spec(monkeypatch, capsys, tmp_path):
    """A spec saved as JSON replaces the inline one, in both packages."""
    from repro_torch import box
    path = tmp_path / "spec.json"
    path.write_text(box.ClusterSpec(
        num_clients=200, donor_pages=1 << 16, replication=1, sla="premium",
        service="slo", nic_cost={"num_pus": 8, "wqe_proc_us": 10.0,
                                 "wire_us_per_page": 2.0}).to_json())
    res = capacity_plan.main([str(path), *CPU])
    mine = capsys.readouterr().out
    theirs = run_reference(monkeypatch, capsys, "capacity_plan.py", str(path))
    assert mine.splitlines() == theirs.splitlines()
    assert res["cost"] <= 68          # fewer clients never need more


@pytest.mark.parametrize("example", [quickstart, remote_paging_demo,
                                     serve_paged, capacity_plan],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_example_twins_need_a_gpu_unless_cpu_is_asked(example):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
