"""Finds what ``BENCHMARK.json`` names: a cell's configuration file, its
traffic mix (``workloads/<traffic>.json``), its limits
(``limits/<cell>.json``), the reference a configuration names
(``reference/<name>.py``), each metric's reader (``metrics/<metric>.py``)
and each traffic mix's driver (``drivers/<driver>.py``). Adding a cell, a
mix or a metric means adding files; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


class Cell:
    """One entry of ``workloads`` and everything it names."""

    def __init__(self, name: str, root: Path = ROOT) -> None:
        self.root, self.bench_dir = root, root / "bench"
        self.spec = benchmark(root)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(root / self.config_entry["file"])
        self.traffic = _json(self.bench_dir / "workloads" / f"{self.entry['traffic']}.json")
        self.limits: Dict[str, float] = _json(self.bench_dir / "limits" / f"{name}.json")

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
        return [m for m in self.spec["per_layer" if trace else "end_to_end"] if self._applies(m)]

    def reader(self, metric: str) -> ModuleType:
        return _module(self.bench_dir / "metrics" / f"{metric}.py", f"bench_metric_{metric}")

    def reference(self) -> ModuleType:
        name = self.config["reference"]
        return _module(self.bench_dir / "reference" / f"{name}.py", f"bench_reference_{name}")

    def driver(self) -> ModuleType:
        name = self.traffic["driver"]
        return _module(self.bench_dir / "drivers" / f"{name}.py", f"bench_driver_{name}")
