"""The traced part's arithmetic on a made-up timeline: busy seconds as the
union of device intervals, idle gaps named by the host's operation then."""

import pytest

from bench.lib import trace as tr
from bench.lib.harness import Run
from bench.lib.readers import idle_share, kernel_share, launches_per_unit, step_share


def _seg():
    device = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("Memcpy HtoD", 3.0, 3.5), ("k1", 4.0, 5.0)]
    host = [("bench.decode_step", 0.0, 5.0), ("aten::to", 2.2, 2.9), ("cudaLaunchKernel", 3.6, 3.9)]
    return tr.Segment(device, host, wall_s=10.0, units=[1, 2])


def test_busy_is_the_union():
    assert _seg().busy_s() == pytest.approx(3.5)
    assert tr.union_s([(0, 1), (0.2, 0.4), (2, 3)]) == pytest.approx(2.0)


def test_gaps_and_their_host_names():
    seg = _seg()
    assert tr.gaps(seg.device, 0.0, 5.0) == [(2.0, 3.0), (3.5, 4.0)]
    idle = dict(tr.idle_by_host(seg))
    assert idle["bench.decode_step > aten::to"] == pytest.approx(1.0)
    assert idle["bench.decode_step > cudaLaunchKernel"] == pytest.approx(0.5)
    top = tr.device_ops(seg)
    assert top[0][0] == "k1" and top[0][1] == pytest.approx(2.0)


def test_readers_on_the_timeline():
    r = Run("c", {}, {}, 0, 1.0, True, None, 0.0, None)
    r.segment = _seg()
    assert launches_per_unit(r) == 1.5          # three kernels, two units; copies not counted
    assert idle_share(r, lambda u: u) is None   # no untraced units yet
    r.untraced, r.untraced_s = [1, 2, 3], 12.0
    # busy 3.5 s over traced work 3, carried to untraced work 6: 7 s of 12
    assert idle_share(r, lambda u: u) == pytest.approx(100.0 * (1 - 7.0 / 12.0))
    assert step_share(r, lambda u: 0.5 * u) == pytest.approx(25.0)
    assert kernel_share(r, r"^k1$", lambda u: 1.0) == pytest.approx(100.0)
    assert kernel_share(r, r"nothing", lambda u: 1.0) is None
    r.segment = None
    assert idle_share(r, lambda u: u) is None and launches_per_unit(r) is None
