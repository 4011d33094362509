"""The harness finds cells, mixes, limits and metrics by name: a new
workload file is picked up with no file that exists edited."""

import json
import shutil
from pathlib import Path

import pytest

from bench.lib import spec
from bench.tests.cells import ROOT, run_small  # noqa: F401

BENCH = Path(ROOT) / "bench"


def _copy(tmp_path: Path) -> Path:
    shutil.copy(Path(ROOT) / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    return tmp_path


def test_every_cell_resolves():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.Cell(w["name"])
        assert cell.traffic["driver"] and cell.limits
        cell.driver()
        cell.reference()
        for trace in (False, True):
            for m in cell.metrics(trace):
                assert hasattr(cell.reader(m["name"]), "read")
        names = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in names and len(names) >= 2
        assert cell.metrics(True)


def test_new_workload_file_is_found_without_edits(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*") if p.is_file()}
    mix = json.loads((root / "bench/workloads/chat_continue.json").read_text())
    mix.update(sessions=8, history={"median": 700, "sigma": 0.5, "range": [512, 1024]})
    (root / "bench/workloads/chat_short.json").write_text(json.dumps(mix))
    (root / "bench/limits/command-r-35b.chat_short.json").write_text('{"served_gap": 1.0}')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "command-r-35b.chat_short", "config": "command-r-35b",
                               "traffic": "chat_short", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("command-r-35b.chat_short", root)
    assert cell.traffic["sessions"] == 8 and cell.driver().__name__.endswith("decode")
    assert [m["name"] for m in cell.metrics(False)] == ["setup_s"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_new_metric_reader_is_found(tmp_path):
    root = _copy(tmp_path)
    (root / "bench/metrics/itl_p50_ms.py").write_text(
        "from bench.lib.readers import percentile\n"
        "def read(r):\n    xs = r.samples.get('itl_ms')\n"
        "    return percentile(xs, 50) if xs else None\n")
    cell = spec.Cell("command-r-35b.decode", root)
    assert callable(cell.reader("itl_p50_ms").read)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.Cell("no-such-cell")
