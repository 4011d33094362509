"""The traced part of a run: ``torch.profiler`` over a few steady units of
work, kept in memory (no timeline file is written).

``capture(fn, host=False)`` records device activity only, so the host pays
almost nothing and the idle share is the program's; ``host=True`` adds the
host's operations, to name what the host was doing in each idle gap (a
second, shorter capture). From the device activity: the seconds in which
an operation ran (the union of every kernel, copy and fill), the kernels
by name, and the idle gaps between them.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Event = Tuple[str, float, float]       # (name, start s, end s) on the profiler's clock

HOST_SCAN = 256                        # host events looked back over for a gap


@dataclass
class Segment:
    device: List[Event]                # kernels, copies and fills
    host: List[Event] = field(default_factory=list)
    wall_s: float = 0.0                # host clock from the first launch to the sync
    units: list = field(default_factory=list)   # the driver's records of the work run

    @property
    def kernels(self) -> List[Event]:
        return [e for e in self.device if not _is_copy(e[0])]

    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.device])

    def kernel_s(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name ``match`` takes."""
        sel = [e for e in self.kernels if match(e[0])]
        return sum(e - s for _, s, e in sel), len(sel)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def union_s(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(device: Sequence[Event], start: float, stop: float) -> List[Tuple[float, float]]:
    """Idle intervals of the device between ``start`` and ``stop``."""
    out, cur = [], start
    for _, s, e in sorted(device, key=lambda ev: ev[1]):
        if s > cur:
            out.append((cur, min(s, stop)))
        cur = max(cur, e)
    if stop > cur:
        out.append((cur, stop))
    return [(a, b) for a, b in out if b > a]


def capture(fn: Callable[[], object], *, host: bool = False) -> Segment:
    """Run ``fn`` (which launches work) under the profiler and synchronise."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    dev, cpu = [], []
    for ev in prof.profiler.kineto_results.events():
        rec = (ev.name(), ev.start_ns() * 1e-9, (ev.start_ns() + ev.duration_ns()) * 1e-9)
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            cpu.append(rec)
        elif not (ev.is_user_annotation() or rec[0].startswith("bench.")):
            dev.append(rec)                    # (a span's image on the device is no work)
    return Segment(dev, cpu if host else [], wall)


def top(items: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]


def device_ops(seg: Segment, n: int = 10) -> List[list]:
    """The device operations that took most time: [[name, seconds]]."""
    by = defaultdict(float)
    for name, s, e in seg.device:
        by[name[:120]] += e - s
    return top(by, n)


def idle_by_host(seg: Segment, n: int = 10) -> List[list]:
    """Idle device time by what the host was doing at each gap's midpoint: the
    innermost host operation running then, under the benchmark's span
    (``bench.*``) that holds it: [[name, seconds]], summed over the gaps."""
    if not seg.host or not seg.device:
        return []
    host = sorted(seg.host, key=lambda ev: ev[1])
    starts = [s for _, s, _ in host]
    spans = [ev for ev in host if ev[0].startswith("bench.")]
    first = min(s for _, s, _ in seg.device)
    last = max(e for _, _, e in seg.device)
    by = defaultdict(float)
    for a, b in gaps(seg.device, first, last):
        mid = 0.5 * (a + b)
        by[_host_at(host, starts, spans, mid)] += b - a
    return top(by, n)


def _host_at(host: List[Event], starts: List[float], spans: List[Event], t: float) -> str:
    span = next((nm for nm, s, e in reversed(spans) if s <= t <= e), None)
    i = bisect.bisect_right(starts, t)
    inner: Optional[str] = None
    for name, s, e in reversed(host[max(0, i - HOST_SCAN):i]):
        if e >= t and not name.startswith("bench."):
            inner = name
            break
    inner = inner or "python, between operations"
    return f"{span} > {inner}" if span else inner
