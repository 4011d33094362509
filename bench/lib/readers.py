"""What the metric readers in ``bench/metrics/`` share. A reader takes the
run (``bench.lib.harness.Run``) and returns its number, or None where the
run has nothing for it to read; it never returns 0 for a share."""

from __future__ import annotations

import re
from typing import Callable, Optional

from bench.lib.stats import percentile, rate


def window_rate(r, count: str) -> Optional[float]:
    if count not in r.counts or not r.window_s > 0:
        return None
    return rate(r.counts[count], r.window_s)


def p95(r, sample: str) -> Optional[float]:
    xs = r.samples.get(sample)
    return percentile(xs, 95) if xs else None


def launches_per_unit(r) -> Optional[float]:
    seg = r.segment
    if seg is None or not seg.units or not seg.kernels:
        return None
    return len(seg.kernels) / len(seg.units)


def idle_share(r, least_s: Callable[[object], float]) -> Optional[float]:
    """Share of the window's untraced host seconds in which nothing ran on
    the device, in %: the traced part's device-busy seconds per unit of work
    (``least_s(unit)``, each unit's least time) carried over to the untraced
    units' work. The profiler lengthens the traced part's host time, not the
    device's work, so its cost is not counted as idle."""
    seg = r.segment
    if (seg is None or not seg.device or not seg.units or not r.untraced
            or not r.untraced_s > 0):
        return None
    traced_work = sum(least_s(u) for u in seg.units)
    if not traced_work > 0:
        return None
    busy = seg.busy_s() * sum(least_s(u) for u in r.untraced) / traced_work
    return 100.0 * (1.0 - busy / r.untraced_s)


def step_share(r, least_s: Callable[[object], float]) -> Optional[float]:
    """The whole step's share of the card's peak, in %: the least time of every
    untraced unit of the window (``least_s(unit)``) over the window's host
    seconds without its traced part, so the profiler's cost is not counted.
    Read in a traced run only, as the other per-layer metrics."""
    if r.segment is None or not r.segment.device or not r.untraced or not r.untraced_s > 0:
        return None
    return 100.0 * sum(least_s(u) for u in r.untraced) / r.untraced_s


def kernel_share(r, pattern: str, least_s: Callable[[object], float]) -> Optional[float]:
    """A kernel's share of its roofline: the least time of its calls in the
    traced units (``least_s(unit)`` for each) over the device time of the
    kernels whose name matches ``pattern``, in %."""
    seg = r.segment
    if seg is None or not seg.units:
        return None
    rx = re.compile(pattern)
    device_s, n = seg.kernel_s(lambda name: rx.search(name) is not None)
    if n == 0 or not device_s > 0:
        return None
    return 100.0 * sum(least_s(u) for u in seg.units) / device_s

