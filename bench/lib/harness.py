"""One run of one cell: the driver's set-up, window and check, then the
result line the benchmark prints.

``execute`` is what ``bench/run.py`` calls; the CPU tests call it too, with
a small configuration and traffic and ``device="cpu"`` (the kernels' plain
versions). Everything the program is asked to do goes through the driver
that the cell's traffic mix names; every number printed comes from a
metric reader that ``BENCHMARK.json`` names.
"""

from __future__ import annotations

import gc
import math
import resource
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench.lib import trace as tr
from bench.lib.spec import ROOT, Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_AT = 0.4          # the traced part starts this far into the window


@dataclass
class Run:
    """What a driver is given, and what it records."""

    cell: str
    model: dict                      # the configuration's sizes (its file's "model")
    traffic: dict                    # the traffic mix
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                        # process start, on time.perf_counter's clock
    reference: ModuleType
    setup_s: float = math.nan        # process start to the first timed operation
    window_s: float = math.nan       # host clock over the measured window
    samples: Dict[str, List[float]] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    segment: Optional[tr.Segment] = None        # device activity of the traced part
    host_segment: Optional[tr.Segment] = None   # the same with the host's operations
    readings: Dict[str, float] = field(default_factory=dict)   # compared with limits
    memory_peak_bytes: int = 0
    notes: Dict[str, object] = field(default_factory=dict)
    control: Optional[str] = None    # bench/tools/control.py only: also read the control
    untraced: list = field(default_factory=list)   # work records of the window's untraced units
    untraced_s: float = math.nan     # the window's host seconds less the traced part's


def memory_peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(device: torch.device) -> None:
    """Free what the program held before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def measure(r: Run, unit: Callable[[], None], records: list, trace_units: int,
            trace_host_units: int) -> None:
    """The window: ``unit()`` (one decode step, request or train step, which
    appends its work record to ``records``) again and again until ``r.seconds``
    have passed on the host clock, then a sync. With ``r.trace``, the traced
    part runs ``TRACE_AT`` into the window: ``trace_units`` units with the
    device's activity recorded, then ``trace_host_units`` with the host's too.
    Sets the set-up and window seconds, the memory peak, and the records and
    host seconds of the window without its traced part."""
    gc.collect()
    gc.freeze()                  # what set-up made is never scanned again,
    gc.disable()                 # and no collection pauses a unit in the window
    try:
        t_start = time.perf_counter()
        r.setup_s = t_start - r.t0
        first, traced, traced_s = len(records), range(0), 0.0
        stamps = [(t_start, time.thread_time())]
        switches = resource.getrusage(resource.RUSAGE_SELF)
        while True:
            unit()
            stamps.append((time.perf_counter(), time.thread_time()))
            if r.trace and not traced and time.perf_counter() - t_start >= TRACE_AT * r.seconds:
                t_traced, k = time.perf_counter(), len(records)
                r.segment = _capture(unit, records, trace_units, host=False)
                r.host_segment = _capture(unit, records, trace_host_units, host=True)
                traced, traced_s = range(k, len(records)), time.perf_counter() - t_traced
            if time.perf_counter() - t_start >= r.seconds:
                break
        sync(r.device)
        r.window_s = time.perf_counter() - t_start
    finally:
        gc.enable()
        gc.unfreeze()
    r.memory_peak_bytes = memory_peak(r.device)
    r.notes["host"] = _host_notes(stamps, switches)
    r.untraced = [records[i] for i in range(first, len(records)) if i not in traced]
    r.untraced_s = r.window_s - traced_s


def _host_notes(stamps: list, before) -> dict:
    """How the host spent the window, by tenths of its units: the mean host
    ms a unit on the wall clock and on this thread's CPU clock (which may
    tick in 10 ms steps, hence means), and the process's context switches
    over the window. A wall time that drifts while the CPU time holds is
    time the thread waited or was preempted; one that the CPU time follows
    is the host's own speed."""
    wall = np.diff([s[0] for s in stamps]) * 1e3
    cpu = np.diff([s[1] for s in stamps]) * 1e3
    k = max(1, len(wall) // 10)
    after = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_ms_by_tenth": [float(wall[i:i + k].mean()) for i in range(0, len(wall), k)][:10],
            "cpu_ms_by_tenth": [float(cpu[i:i + k].mean()) for i in range(0, len(cpu), k)][:10],
            "voluntary_switches": after.ru_nvcsw - before.ru_nvcsw,
            "involuntary_switches": after.ru_nivcsw - before.ru_nivcsw}


def judge(limits: Dict[str, float], readings: Dict[str, float]):
    """(correct, checks): each number beside its limit; correct when every
    number is there and within its limit."""
    checks = {}
    for k, lim in limits.items():
        v = float(readings.get(k, math.nan))
        checks[k] = {"value": v if math.isfinite(v) else None, "limit": lim}
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values()), checks


def _capture(unit, records: list, n: int, host: bool) -> tr.Segment:
    k0 = len(records)
    seg = tr.capture(lambda: [unit() for _ in range(n)], host=host)
    seg.units = list(records[k0:k0 + n])
    return seg


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell_name: str, *, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t0: Optional[float] = None, root: Path = ROOT,
            model: Optional[dict] = None, traffic: Optional[dict] = None,
            limits: Optional[dict] = None, control: Optional[str] = None) -> dict:
    """Run the cell once; returns the result object (``checks`` last).
    ``model``/``traffic``/``limits`` update the files' values (the CPU
    tests' sizes, and limits set from readings at those sizes).
    With ``control`` (a precision of the reference), the reference in that
    precision also stands in the program's place, and its readings are
    judged by the cell's limits under ``control``."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(cell_name, root)
    run = Run(cell.name, {**cell.config["model"], **(model or {})},
              {**cell.traffic, **(traffic or {})}, seed, seconds, trace,
              torch.device(device), t0, cell.reference(), control=control)
    cell.driver().run(run)
    limits = {**cell.limits, **(limits or {})}
    correct, checks = judge(limits, run.readings)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct, "attempted": int(run.counts.get("attempted", 0)),
           "failed": int(run.counts.get("failed", 0)), "metrics": metrics, "device": dev}
    if trace and run.segment is not None:
        dev["busy_s"] = run.segment.busy_s()
        dev["window_s"] = run.segment.wall_s
        out["breakdown"] = {"device_ops": tr.device_ops(run.segment),
                            "idle_gaps": tr.idle_by_host(run.host_segment or run.segment)}
    out["notes"] = run.notes
    if control:                  # the control's readings, judged by the same limits
        ctl_correct, ctl_checks = judge(limits, run.notes.get("control") or {})
        out["control"] = {"precision": control, "correct": ctl_correct, "checks": ctl_checks}
    out["checks"] = checks
    return out
