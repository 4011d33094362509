"""Workload description + the analytic traffic-share estimates.

The threaded engine *measures* a workload; the model must be *told*
one. ``ModelWorkload`` is that contract: per-client offered rate, op
shape (pages, read fraction), access skew (zipf ``s`` over a per-donor
working set), and the two variability knobs the queueing formulas use.
Everything has a default so ``box.open(spec, backend="model")`` yields
estimates immediately; benchmarks and the calibration harness pass the
exact workload they drive the simulator with.

The zipf helpers are the closed-form counterparts of
``benchmarks.common.zipfian_*``: the share of traffic landing on the
hottest ``top`` of ``n`` pages is ``H(top, s) / H(n, s)`` with ``H``
the generalized harmonic number — evaluated exactly for small ``n`` and
via the Euler–Maclaurin tail otherwise, so a 500x64 sweep never loops
over millions of ranks.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, replace
from typing import Any, Dict, Optional

# exact-summation cutoff for generalized harmonic numbers
_EXACT_N = 4096


def harmonic(n: int, s: float) -> float:
    """Generalized harmonic number ``H(n, s) = sum_{k=1..n} k^-s``.

    Exact below ``_EXACT_N``; Euler–Maclaurin (integral + boundary +
    first derivative correction) above — relative error < 1e-6 for the
    cache-sizing regime (``s`` in [0, ~2], ``n`` up to many millions).
    """
    if n <= 0:
        return 0.0
    if n <= _EXACT_N:
        return sum(k ** -s for k in range(1, n + 1))
    head = sum(k ** -s for k in range(1, _EXACT_N))
    m = float(_EXACT_N)        # integrate the tail [m, n]
    if abs(s - 1.0) < 1e-12:
        integral = math.log(n / m)
    else:
        integral = (n ** (1.0 - s) - m ** (1.0 - s)) / (1.0 - s)
    correction = 0.5 * (m ** -s + n ** -s) \
        + (s / 12.0) * (m ** -(s + 1.0) - n ** -(s + 1.0))
    return head + integral + correction


def zipf_top_share(total_pages: int, top_pages: int, s: float) -> float:
    """Fraction of zipf(``s``) traffic over ``total_pages`` pages that
    lands on the hottest ``top_pages`` — the analytic hit rate of a
    frequency cache of that capacity. ``s == 0`` is uniform."""
    if total_pages <= 0 or top_pages <= 0:
        return 0.0
    top = min(top_pages, total_pages)
    if s == 0.0:
        return top / total_pages
    return harmonic(top, s) / harmonic(total_pages, s)


@dataclass
class ModelWorkload:
    """The offered traffic the analytic engine evaluates a spec under.

    Args:
        client_ops_per_s: offered rate per client, ops per *virtual*
            second (1e6 vus; at the default ``nic_scale=1e-6`` a virtual
            second is one real second). ``None`` sizes the rate to
            ``target_utilization`` of the topology's bottleneck capacity
            — "how does this cluster behave near its knee".
        pages_per_op: payload pages per request.
        read_fraction: fraction of ops that are READs (the rest WRITE).
        zipf_s: page-popularity skew over the per-donor working set
            (0 = uniform — the calibration workload).
        working_set_pages: distinct pages touched per donor region;
            ``None`` means the whole donor region.
        replicate_writes: charge each WRITE to ``spec.replication``
            donors (paging semantics). Off by default — engine-level
            traffic (and every bench that drives ``engine()``) writes
            one donor per op.
        merge_factor: average client-side requests folded into one WQE
            by the merge queue (1.0 = unmergeable random traffic).
        stride_fraction: fraction of the traffic that follows a
            sequential/strided extent stream a stride predictor can
            cover (1.0 = pure scan, 0.0 = unpredictable random). Only
            consulted when the spec enables MR prefetch — it becomes the
            useful-prefetch fraction that turns critical-path faults
            into background registrations.
        arrival_cv2 / service_cv2: squared coefficients of variation
            for the Allen–Cunneen wait (Poisson-ish arrivals over the
            simulator's deterministic service costs by default).
        target_utilization: operating point used when
            ``client_ops_per_s`` is None.

    Raises:
        ValueError: from ``validate`` on a non-positive rate/shape or a
            fraction outside its range.
    """

    client_ops_per_s: Optional[float] = None
    pages_per_op: int = 1
    read_fraction: float = 0.5
    zipf_s: float = 0.0
    working_set_pages: Optional[int] = None
    replicate_writes: bool = False
    merge_factor: float = 1.0
    stride_fraction: float = 0.0
    arrival_cv2: float = 1.0
    service_cv2: float = 0.0
    target_utilization: float = 0.8

    def validate(self) -> "ModelWorkload":
        if self.client_ops_per_s is not None and self.client_ops_per_s <= 0:
            raise ValueError("client_ops_per_s must be > 0 (or None to "
                             "operate at target_utilization of capacity)")
        if self.pages_per_op < 1:
            raise ValueError("pages_per_op must be >= 1")
        if not 0.0 <= self.read_fraction <= 1.0:
            raise ValueError("read_fraction must be in [0, 1]")
        if self.zipf_s < 0.0:
            raise ValueError("zipf_s must be >= 0 (0 = uniform)")
        if self.working_set_pages is not None and self.working_set_pages < 1:
            raise ValueError("working_set_pages must be >= 1 (or None for "
                             "the whole donor region)")
        if self.merge_factor < 1.0:
            raise ValueError("merge_factor must be >= 1")
        if not 0.0 <= self.stride_fraction <= 1.0:
            raise ValueError("stride_fraction must be in [0, 1]")
        if not 0.0 < self.target_utilization < 1.0:
            raise ValueError("target_utilization must be in (0, 1)")
        return self

    @classmethod
    def coerce(cls, value) -> "ModelWorkload":
        if value is None:
            return cls()
        if isinstance(value, ModelWorkload):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"cannot build ModelWorkload from "
                        f"{type(value).__name__}")

    def with_rate(self, ops_per_s: float) -> "ModelWorkload":
        return replace(self, client_ops_per_s=ops_per_s)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)
