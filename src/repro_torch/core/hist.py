"""Fixed-bucket latency histograms — tail latency as a first-class stat.

The paper's headline result is a cut in *tail* latency, yet a mean (or
an EWMA) cannot even observe a p99. ``LatencyHistogram`` is the one
histogram type threaded through the engine: client-side completion
latencies (``client.<i>.box.latency.*``), donor-side per-SLA-class
service latencies (``nic.<n>.service.per_class.*``), and the
``CongestionAwareHook``'s own p99 guard all record into instances of it.

Design constraints, in order:

* **No numpy on the hot path.** ``record`` runs inside the batched
  completion handler and inside donor service workers; it is one
  ``math.log`` + one list increment under a small lock.
* **Fixed log-spaced buckets.** Bucket edges grow geometrically
  (``buckets_per_decade`` per power of ten), so relative quantile error
  is bounded by one bucket width (~15% at the default 16/decade)
  across eight decades of microseconds — the HdrHistogram trade, sized
  down. Two histograms with the same geometry merge by vector addition
  (``merge``), which is how per-worker recordings compose into one
  per-class view.
* **Quantiles from counts.** ``percentile(q)`` walks the cumulative
  counts to the q-th rank and reports the *upper edge* of that bucket —
  a conservative (never under-reported) tail estimate.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

# default geometry: [0.1 us, 1e7 us) at 16 buckets per decade = 128
# buckets + one underflow + one overflow. 1e7 vus is ~3 hours at the
# default nic_scale — anything slower is a hang, not a latency.
DEFAULT_LO_US = 0.1
DEFAULT_HI_US = 1e7
DEFAULT_BUCKETS_PER_DECADE = 16


class LatencyHistogram:
    """Thread-safe fixed-geometry log-bucket histogram of microseconds.

    Args:
        lo_us: lower edge of the first regular bucket; samples below
            land in the underflow bucket (reported as ``<= lo_us``).
        hi_us: upper edge of the last regular bucket; samples at or
            above land in the overflow bucket (reported as ``hi_us``).
        buckets_per_decade: resolution — relative quantile error is
            bounded by ``10**(1/buckets_per_decade) - 1`` (~15% at the
            default 16).

    Raises:
        ValueError: on a non-positive range or resolution.
    """

    __slots__ = ("lo_us", "hi_us", "buckets_per_decade", "_scale",
                 "_nbuckets", "_counts", "_count", "_sum_us", "_max_us",
                 "_lock")

    def __init__(self, lo_us: float = DEFAULT_LO_US,
                 hi_us: float = DEFAULT_HI_US,
                 buckets_per_decade: int = DEFAULT_BUCKETS_PER_DECADE
                 ) -> None:
        if not (0.0 < lo_us < hi_us):
            raise ValueError(f"need 0 < lo_us < hi_us, got "
                             f"[{lo_us}, {hi_us})")
        if buckets_per_decade < 1:
            raise ValueError("buckets_per_decade must be >= 1")
        self.lo_us = lo_us
        self.hi_us = hi_us
        self.buckets_per_decade = buckets_per_decade
        self._scale = buckets_per_decade / math.log(10.0)
        self._nbuckets = int(math.ceil(
            math.log(hi_us / lo_us) * self._scale))
        # [0] underflow, [1.._nbuckets] regular, [-1] overflow
        self._counts: List[int] = [0] * (self._nbuckets + 2)
        self._count = 0
        self._sum_us = 0.0
        self._max_us = 0.0
        self._lock = threading.Lock()

    # ---- recording -------------------------------------------------------
    def _index(self, us: float) -> int:
        if us < self.lo_us:
            return 0
        if us >= self.hi_us:
            return self._nbuckets + 1
        return 1 + int(math.log(us / self.lo_us) * self._scale)

    def record(self, us: float) -> None:
        """Record one latency sample (microseconds). Non-positive samples
        are dropped — a zero virtual latency means the clocks never ran,
        not an infinitely fast path."""
        if us <= 0.0:
            return
        idx = self._index(us)
        with self._lock:
            # log() rounding at an exact edge can land one past the last
            # regular bucket; clamp inside the lock-free index instead of
            # paying a branch per regular sample
            if idx > self._nbuckets + 1:
                idx = self._nbuckets + 1
            self._counts[idx] += 1
            self._count += 1
            self._sum_us += us
            if us > self._max_us:
                self._max_us = us

    def record_many(self, samples) -> None:
        """Record an iterable of samples under ONE lock acquisition (the
        batched completion handler's path)."""
        prepared = [(self._index(us), us) for us in samples if us > 0.0]
        if not prepared:
            return
        top = self._nbuckets + 1
        total = sum(us for _, us in prepared)
        peak = max(us for _, us in prepared)
        with self._lock:
            for idx, _ in prepared:
                self._counts[idx if idx <= top else top] += 1
            self._count += len(prepared)
            self._sum_us += total
            if peak > self._max_us:
                self._max_us = peak

    # ---- merging ---------------------------------------------------------
    def merge(self, other: "LatencyHistogram") -> None:
        """Add ``other``'s counts into this histogram (per-worker →
        per-class composition).

        Raises:
            ValueError: when the two histograms' bucket geometries differ
                (counts would land in the wrong buckets).
        """
        if (other.lo_us, other.hi_us, other.buckets_per_decade) != \
                (self.lo_us, self.hi_us, self.buckets_per_decade):
            raise ValueError(
                f"cannot merge histograms with different geometry: "
                f"({self.lo_us}, {self.hi_us}, {self.buckets_per_decade})"
                f" vs ({other.lo_us}, {other.hi_us}, "
                f"{other.buckets_per_decade})")
        with other._lock:
            counts = list(other._counts)
            count = other._count
            sum_us = other._sum_us
            max_us = other._max_us
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += count
            self._sum_us += sum_us
            if max_us > self._max_us:
                self._max_us = max_us

    # ---- reading ---------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def _edge(self, idx: int) -> float:
        """Upper edge of bucket ``idx`` in microseconds."""
        if idx <= 0:
            return self.lo_us
        if idx >= self._nbuckets + 1:
            return self.hi_us
        return self.lo_us * 10.0 ** (idx / self.buckets_per_decade)

    def percentile(self, q: float) -> float:
        """The q-th percentile (``q`` in [0, 100]) as the upper edge of
        the bucket holding that rank — a conservative tail estimate whose
        relative error is bounded by one bucket width. Returns 0.0 for an
        empty histogram.

        Raises:
            ValueError: when ``q`` is outside [0, 100].
        """
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile {q} outside [0, 100]")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = q / 100.0 * self._count
            seen = 0
            for idx, c in enumerate(self._counts):
                seen += c
                if seen >= rank and c:
                    return min(self._edge(idx), self._max_us)
            return self._max_us

    def snapshot(self) -> Dict[str, float]:
        """One stats-tree leaf dict: count, mean, p50/p99/p999, max (all
        microseconds). Cheap enough to call per stats() pull."""
        with self._lock:
            if self._count == 0:
                return {"count": 0, "mean_us": 0.0, "p50_us": 0.0,
                        "p99_us": 0.0, "p999_us": 0.0, "max_us": 0.0}
            mean = self._sum_us / self._count
        return {
            "count": self.count,
            "mean_us": mean,
            "p50_us": self.percentile(50.0),
            "p99_us": self.percentile(99.0),
            "p999_us": self.percentile(99.9),
            "max_us": self._max_us,
        }

    @classmethod
    def empty_snapshot(cls) -> Dict[str, float]:
        """The zero-shape dict, for unconditionally addressable
        namespaces (mirrors ``CacheTier.disabled_snapshot``)."""
        return {"count": 0, "mean_us": 0.0, "p50_us": 0.0, "p99_us": 0.0,
                "p999_us": 0.0, "max_us": 0.0}


def percentile_of(samples, q: float,
                  hist: Optional[LatencyHistogram] = None) -> float:
    """Convenience: load ``samples`` into a (fresh) histogram and read one
    percentile — benchmark/test helper, not a hot path."""
    h = hist or LatencyHistogram()
    for s in samples:
        h.record(s)
    return h.percentile(q)
