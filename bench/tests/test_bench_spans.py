"""The program spans' readings (``bench.lib.spans``) on made-up timelines:
self time under nested spans, idle gaps put down to the innermost span or
to none, launches on a second thread inside the main thread's span, copies
and fills matched like kernels, records the profiler lost at a capture's
ends placed by kind, counts that no way matches, and a program without
spans, which every reader leaves out."""

import pytest

from bench.lib import spans
from bench.lib import trace as tr
from bench.lib.harness import Run
from bench.lib.spec import Cell

P = spans.PREFIX
READERS = ["plan_ms.decode", "idle_in_layers.decode", "attn_device_ms.decode",
           "ssm_device_ms.decode", "adamw_launches.train", "adamw_device_ms.train"]


def _decode_seg():
    """One decode step from 0 to 10: the plan, two layers (attention, FFN),
    the logits, each launching one or more operations; idle gaps in the
    attention, the FFN, the second layer between its mixer and FFN, the
    logits, and after the step."""
    host = [("bench.decode_step", 0.0, 10.0), (P + "decode.step", 0.0, 9.0),
            (P + "kv.plan", 0.0, 1.0), ("cudaMemcpyAsync", 0.8, 0.9),
            (P + "layer", 1.0, 4.0), (P + "layer.attn", 1.0, 2.5),
            ("aten::mm", 1.1, 1.3), ("cudaLaunchKernel", 1.2, 1.25),
            ("cudaLaunchKernel", 2.0, 2.1), (P + "layer.ffn", 2.5, 4.0),
            ("cuLaunchKernelEx", 3.0, 3.1),
            (P + "layer", 4.0, 8.0), (P + "layer.attn", 4.0, 5.0),
            ("cudaLaunchKernelExC", 4.5, 4.6), (P + "layer.ffn", 6.5, 8.0),
            ("cudaMemsetAsync", 7.0, 7.1),
            (P + "decode.logits", 8.0, 9.0), ("cudaLaunchKernel", 8.5, 8.6),
            ("cudaLaunchKernel", 9.5, 9.6)]
    device = [("Memcpy HtoD", 0.95, 1.05), ("k_qkv", 1.3, 1.8), ("k_attn", 2.2, 2.6),
              ("k_ffn", 3.2, 3.6), ("k_attn", 4.7, 5.2), ("Memset", 7.2, 7.3),
              ("k_head", 8.7, 9.2), ("k_argmax", 9.7, 9.8)]
    return tr.Segment(device, host, wall_s=10.0, units=[0])


def test_self_time_less_the_child_spans():
    got = spans.self_s(_decode_seg())
    assert got["decode.step"] == pytest.approx(9.0 - 1.0 - 3.0 - 4.0 - 1.0)
    assert got["layer"] == pytest.approx((3.0 - 1.5 - 1.5) + (4.0 - 1.0 - 1.5))
    assert got["kv.plan"] == pytest.approx(1.0)
    assert got["layer.attn"] == pytest.approx(2.5)
    assert "bench.decode_step" not in got and spans.OUTSIDE not in got


def test_idle_goes_to_the_innermost_span_or_outside():
    got = spans.idle_s(_decode_seg())
    # gaps: 1.05-1.3 and 1.8-2.2 (attention), 2.6-3.2 (FFN), 3.6-4.7 (the second
    # layer's attention at 4.15), 5.2-7.2 (its layer at 6.2), 7.3-8.7 (the
    # logits at 8.0: the later span to start is the inner), 9.2-9.7 (outside)
    assert got["layer.attn"] == pytest.approx(0.25 + 0.4 + 1.1)
    assert got["layer"] == pytest.approx(2.0)
    assert got["layer.ffn"] == pytest.approx(0.6)
    assert got["decode.logits"] == pytest.approx(1.4)
    assert got[spans.OUTSIDE] == pytest.approx(0.5)
    assert sum(got.values()) == pytest.approx(sum(b - a for a, b in tr.gaps(
        _decode_seg().device, 0.95, 9.8)))


def test_copies_and_fills_are_matched_like_kernels():
    seg = _decode_seg()
    assert spans.launches(seg) == {"kv.plan": 1, "layer.attn": 3, "layer.ffn": 2,
                                   "decode.logits": 1, spans.OUTSIDE: 1}
    dev = spans.device_s(seg)
    assert dev["kv.plan"] == pytest.approx(0.1)              # the copy up
    assert dev["layer.attn"] == pytest.approx(0.5 + 0.4 + 0.5)
    assert dev["layer.ffn"] == pytest.approx(0.4 + 0.1)      # a kernel and a fill
    assert dev["decode.logits"] == pytest.approx(0.5)
    assert dev[spans.OUTSIDE] == pytest.approx(0.1)


def test_a_launch_on_another_thread_goes_to_the_span_holding_it():
    """The backward's launches come from autograd's thread while the main
    thread sits in ``train.backward``; a span that thread enters (a block
    recomputed) is the innermost for its own launches."""
    host = [(P + "train.forward", 0.0, 1.0), ("cudaLaunchKernel", 0.5, 0.6),
            (P + "train.backward", 1.0, 5.0),
            ("cudaLaunchKernel", 1.5, 1.6), (P + "layer", 2.0, 3.0),
            ("cudaLaunchKernel", 2.5, 2.6), ("cudaLaunchKernel", 4.0, 4.1),
            (P + "train.optimizer", 5.0, 6.0), ("cudaLaunchKernel", 5.5, 5.6),
            ("cudaMemcpyAsync", 5.7, 5.8)]
    device = [("fwd", 0.7, 0.9), ("bwd_a", 1.7, 2.0), ("recompute", 2.7, 2.8),
              ("bwd_b", 4.2, 4.9), ("adam", 5.6, 5.7), ("Memcpy DtoD", 5.85, 5.9)]
    seg = tr.Segment(device, host, wall_s=6.0, units=[1])
    assert spans.launches(seg) == {"train.forward": 1, "train.backward": 2, "layer": 1,
                                   "train.optimizer": 2}
    dev = spans.device_s(seg)
    assert dev["train.backward"] == pytest.approx(0.3 + 0.7)
    assert dev["layer"] == pytest.approx(0.1)
    assert dev["train.optimizer"] == pytest.approx(0.1 + 0.05)


def test_a_count_that_does_not_match_gives_none():
    """An operation missing between the ends (the fill), more operations
    than calls, or a lost record that kernels alone cannot place (the first
    or the last call could be its): None."""
    seg = _decode_seg()
    seg.device = [ev for ev in seg.device if ev[0] != "Memset"]
    assert spans.device_s(seg) is None
    assert spans.launches(seg) is not None      # the calls alone are still counted
    seg = _decode_seg()
    seg.device = seg.device + [("k_extra", 9.85, 9.9)]
    assert spans.device_s(seg) is None
    host = [(P + "layer.attn", 0.0, 1.0), ("cudaLaunchKernel", 0.1, 0.2),
            (P + "layer.ffn", 1.0, 2.0), ("cudaLaunchKernel", 1.1, 1.2),
            ("cudaLaunchKernel", 1.5, 1.6)]
    seg = tr.Segment([("k_attn", 0.3, 0.4), ("k_ffn", 1.3, 1.4)], host, units=[0])
    assert spans.device_s(seg) is None


@pytest.mark.parametrize("lost", ["first", "last"])
def test_records_lost_at_an_end_are_found_by_kind(lost):
    """The profiler lost the first operation (the copy up) or the last (the
    argmax): only one way of leaving out a call fits the kinds, and every
    other operation goes where its launch was."""
    seg = _decode_seg()
    seg.device = seg.device[1:] if lost == "first" else seg.device[:-1]
    dev = spans.device_s(seg)
    assert dev["layer.attn"] == pytest.approx(0.5 + 0.4 + 0.5)
    assert dev["layer.ffn"] == pytest.approx(0.4 + 0.1)
    assert dev["decode.logits"] == pytest.approx(0.5)
    assert ("kv.plan" in dev) == (lost == "last")
    assert (spans.OUTSIDE in dev) == (lost == "first")


def _run(seg) -> Run:
    r = Run("c", {}, {}, 0, 1.0, True, None, 0.0, None)
    r.host_segment = seg
    return r


def test_readers_on_the_timeline():
    r = _run(_decode_seg())
    read = {m: Cell("command-r-35b.decode").reader(m).read(r) for m in READERS}
    assert read["plan_ms.decode"] == pytest.approx(1e3)
    idle = spans.idle_s(r.host_segment)
    assert read["idle_in_layers.decode"] == pytest.approx(
        100.0 * (0.25 + 0.4 + 1.1 + 2.0 + 0.6) / sum(idle.values()))
    assert read["attn_device_ms.decode"] == pytest.approx(1.4e3)
    assert read["ssm_device_ms.decode"] is None          # no such span ran
    assert read["adamw_launches.train"] is None


@pytest.mark.parametrize("seg", [
    None, tr.Segment([("k", 0.0, 1.0)], [], units=[0]),
    tr.Segment([("k", 0.0, 1.0), ("k", 2.0, 3.0)],
               [("bench.decode_step", 0.0, 3.0), ("cudaLaunchKernel", 0.0, 0.1),
                ("cudaLaunchKernel", 1.5, 1.6)], units=[0])],
    ids=["no capture", "no host events", "a program without spans"])
def test_nothing_to_read_reads_none(seg):
    r = _run(seg)
    assert all(Cell("command-r-35b.decode").reader(m).read(r) is None for m in READERS)
