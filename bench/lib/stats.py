"""Percentiles, rates and spreads, each over every sample given."""

from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


def percentile(samples: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of all ``samples`` (linear between order
    statistics), never of per-chunk summaries."""
    if len(samples) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


def rate(count: float, seconds: float) -> float:
    """Work done over the whole window, per second."""
    if seconds <= 0:
        raise ValueError("empty window")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile, as a share of the median
    (``statistics.quantiles``, its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
