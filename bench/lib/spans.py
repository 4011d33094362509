"""The program's own spans in a traced part that recorded the host's
operations (``Segment.host``): ``repro_torch.*`` events, which the program
enters at its layer boundaries on the profiler's clock, the clock to which
the profiler converts the device activity beside them.

Three readings, each keyed by span name without the ``repro_torch.``
prefix, ``OUTSIDE`` for what no program span holds:

- ``self_s``: each span's host seconds less what its child spans cover;
- ``idle_s``: each device-idle gap, put down to the innermost span running
  at its midpoint;
- ``launches`` and ``device_s``: each launch-API call (kernel, copy, fill),
  put down to the innermost span whose interval holds it. ``device_s``
  matches the calls, in time order, one to one with the device operations
  in start order, and sums each operation's device seconds where its launch
  was; the capture synchronises before it starts and the model path runs on
  one stream, so the two orders are the same.

The profiler keeps only the device records that its clock puts inside the
capture, and its device clock can read some tens of microseconds off the
host's: a capture may lose the records of its first (or last) operations,
never of one in between (on an H100, up to twelve at a capture's start).
So where there are k more calls than operations, ``device_s`` tries each
way of leaving out k calls from the two ends, and keeps the one under
which every call and its operation are of one kind (kernel, copy, fill).
Where no way, or more than one, fits it returns None: it never guesses.
The lost operations' device time is not counted.

A span on one thread holds the launches of another in its interval (the
backward's launches fall inside ``train.backward``), so spans are matched
by time alone. A segment with no program span gives None everywhere: a
program that has no spans has nothing for these readings.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from bench.lib.trace import Event, Segment, gaps, union_s

PREFIX = "repro_torch."
OUTSIDE = "outside the program"
LAUNCH_APIS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset"})


class _Spans:
    """The program spans of a segment, sorted by start, found by time."""

    def __init__(self, seg: Segment) -> None:
        self.spans: List[Event] = sorted(
            ((name[len(PREFIX):], s, e) for name, s, e in seg.host if name.startswith(PREFIX)),
            key=lambda ev: (ev[1], -ev[2]))
        self.starts = [s for _, s, _ in self.spans]

    def at(self, t: float) -> str:
        """The innermost span running at ``t``: the latest to start of those
        whose interval holds it."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            name, _, e = self.spans[i]
            if e >= t:
                return name
        return OUTSIDE


def _spans(seg: Optional[Segment]) -> Optional[_Spans]:
    if seg is None or not seg.host:
        return None
    sp = _Spans(seg)
    return sp if sp.spans else None


def self_s(seg: Optional[Segment]) -> Optional[Dict[str, float]]:
    """Host seconds by span name, each span's duration less the union of the
    program spans inside its interval."""
    sp = _spans(seg)
    if sp is None:
        return None
    out: Dict[str, float] = defaultdict(float)
    for i, (name, s, e) in enumerate(sp.spans):
        inner = []
        for _, cs, ce in sp.spans[i + 1:]:
            if cs > e:
                break
            if ce <= e:
                inner.append((cs, ce))
        out[name] += (e - s) - union_s(inner)
    return dict(out)


def idle_s(seg: Optional[Segment]) -> Optional[Dict[str, float]]:
    """Device-idle seconds between the segment's first and last device
    operation, by the innermost span running at each gap's midpoint."""
    sp = _spans(seg)
    if sp is None or not seg.device:
        return None
    first = min(s for _, s, _ in seg.device)
    last = max(e for _, _, e in seg.device)
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps(seg.device, first, last):
        out[sp.at(0.5 * (a + b))] += b - a
    return dict(out)


def _launches(seg: Segment) -> List[Event]:
    return sorted((ev for ev in seg.host if ev[0] in LAUNCH_APIS), key=lambda ev: ev[1])


def launches(seg: Optional[Segment]) -> Optional[Dict[str, int]]:
    """Launch-API calls by the innermost span whose interval holds each."""
    sp = _spans(seg)
    if sp is None:
        return None
    out: Dict[str, int] = defaultdict(int)
    for _, s, _ in _launches(seg):
        out[sp.at(s)] += 1
    return dict(out)


def _kind(name: str) -> str:
    """A launch-API call's or a device operation's kind: copy, fill or kernel."""
    return "copy" if "Memcpy" in name else "fill" if "Memset" in name else "kernel"


def device_s(seg: Optional[Segment]) -> Optional[Dict[str, float]]:
    """Device seconds by the span that launched each operation; None where
    the launch-API calls cannot be matched to the device operations."""
    sp = _spans(seg)
    if sp is None or not seg.device:
        return None
    calls = _launches(seg)
    ops = sorted(seg.device, key=lambda ev: ev[1])
    lost = len(calls) - len(ops)
    if lost < 0:
        return None
    call_kinds = [_kind(name) for name, _, _ in calls]
    op_kinds = [_kind(name) for name, _, _ in ops]
    fits = [a for a in range(lost + 1) if call_kinds[a:a + len(ops)] == op_kinds]
    if len(fits) != 1:
        return None
    out: Dict[str, float] = defaultdict(float)
    for (_, t, _), (_, s, e) in zip(calls[fits[0]:], ops):
        out[sp.at(t)] += e - s
    return dict(out)


def per_unit(seg: Optional[Segment], by_span: Optional[Dict[str, float]], name: str,
             scale: float = 1.0) -> Optional[float]:
    """``by_span[name]`` per unit of work in ``seg``, times ``scale``; None
    where nothing was read or no such span ran."""
    if seg is None or not seg.units or by_span is None or name not in by_span:
        return None
    return scale * by_span[name] / len(seg.units)
