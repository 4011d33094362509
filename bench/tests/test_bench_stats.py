"""Percentiles, rates and spreads are taken over every sample."""

import statistics

import numpy as np
import pytest

from bench.lib.readers import p95, window_rate
from bench.lib.stats import percentile, rate, spread


def test_percentile_over_all_samples_not_chunk_medians():
    xs = [1.0] * 90 + [100.0] * 10           # the tail sits in the last tenth
    assert percentile(xs, 95) == pytest.approx(float(np.percentile(xs, 95)))
    assert percentile(xs, 95) == 100.0
    chunks = [statistics.median(xs[i:i + 10]) for i in range(0, 100, 10)]
    assert max(chunks) == 100.0 and statistics.median(chunks) == 1.0


def test_percentile_is_order_free_and_needs_samples():
    xs = list(range(1000))
    assert percentile(xs[::-1], 50) == percentile(xs, 50) == 499.5
    with pytest.raises(ValueError):
        percentile([], 95)


def test_rate_is_whole_window():
    assert rate(1000, 4.0) == 250.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_spread_is_interquartile_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / med)


class _Run:
    def __init__(self):
        self.samples = {"itl_ms": [5.0] * 19 + [50.0]}
        self.counts = {"out_tokens": 300}
        self.window_s = 10.0


def test_readers_use_every_sample():
    r = _Run()
    assert p95(r, "itl_ms") == pytest.approx(float(np.percentile(r.samples["itl_ms"], 95)))
    assert window_rate(r, "out_tokens") == 30.0
    assert p95(r, "ttft_ms") is None and window_rate(r, "train_tokens") is None


def test_lengths_are_stratified_draws_from_the_spec():
    from bench.lib.program import lengths, seeded
    spec = {"median": 129, "sigma": 0.8, "range": [128, 512], "multiple": 1}
    a = lengths(spec, 64, seeded(1, 0), block=16)
    b = lengths(spec, 64, seeded(2**31 + 7, 0), block=16)
    assert a.min() >= 128 and a.max() <= 512 and not np.array_equal(a, b)
    for x in (a, b):                 # each block of 16 holds one draw of every stratum
        for blk in x.reshape(4, 16):
            assert sorted(blk)[-1] > 400 and sorted(blk)[0] < 140
    assert abs(a.mean() - b.mean()) < 0.05 * a.mean()      # every seed the same distribution
    assert np.median(a) < a.mean()                          # the tail lies above
    assert (lengths({**spec, "multiple": 64, "range": [1024, 2048], "median": 1500},
                    32, seeded(3, 0)) % 64 == 0).all()
    assert (lengths(2048, 5, seeded(3, 0)) == 2048).all()
