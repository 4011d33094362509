"""``deepseek-v2-lite-5l.train`` end to end at its small size on the CPU
(``bench/tests/cells_moe_train.py``, the kernels' plain versions): correct,
reporting its end-to-end metrics, catching a training step that leaves its
state unchanged or drops half its batch, its control (the reference with
float8 products) reading far above the program and failing the same limits,
and its traced run holding the program's MoE spans, the dropless backward's
among them. The device readings need a device, so every per-layer metric
the cell lists is also read from a made-up card timeline at the cell's own
sizes: each a number, each share under 100 %."""

import time

import numpy as np
import pytest
import torch

from bench.lib import roofline_moe_train, spans
from bench.lib import trace as tr
from bench.lib.harness import Run
from bench.lib.spec import Cell
from bench.tests.cells_moe_train import CELL, MODEL, SEED, TRAFFIC, run_small
from bench.tools import faults

torch.set_num_threads(1)


def test_small_train_cell_runs_and_is_correct():
    out = run_small(trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and set(out["checks"]) == {"grad_gap", "change_gap"}
    for c in out["checks"].values():
        assert np.isfinite(c["value"]) and c["value"] <= c["limit"]
    losses, ref = out["notes"]["losses"], out["notes"]["ref_loss"]
    assert len(losses) == len(ref) == 3
    assert max(abs(a - b) for a, b in zip(losses, ref)) < 0.01     # bf16 against f32


def test_small_train_cell_end_to_end_metrics():
    out = run_small(trace=False)
    assert set(out["metrics"]) == {"train_tok_s", "setup_s"}
    for v in out["metrics"].values():
        assert v["value"] > 0


@pytest.mark.parametrize("fault", ["train_state_unchanged", "half_batch"])
def test_small_train_cell_fault_is_caught(fault):
    with faults.FAULTS[fault]():
        assert not run_small()["correct"]


def test_small_train_cell_control_reads_far_above_the_program():
    """On three seeds the control's largest change_gap is over twice the
    program's largest, and the control is not correct at the cell's limits
    on any of them while the program is."""
    prog, ctl = {}, {}
    for seed in (SEED, SEED + 1, SEED + 2):
        out = run_small(seed=seed, control="fp8")
        assert out["correct"], out["checks"]
        assert out["control"]["correct"] is False, out["control"]
        for k, c in out["checks"].items():
            prog[k] = max(prog.get(k, 0.0), c["value"])
            ctl[k] = max(ctl.get(k, 0.0), out["notes"]["control"][k])
    assert ctl["change_gap"] > 2 * prog["change_gap"], (prog, ctl)


def test_traced_small_cell_holds_the_moe_spans():
    """The traced part's host capture holds ``moe.route``, ``moe.experts``,
    ``moe.combine`` and ``moe.backward``; with no device the device readings
    are left out, never read as 0."""
    cell = Cell(CELL)
    r = Run(cell.name, {**cell.config["model"], **MODEL}, {**cell.traffic, **TRAFFIC}, SEED,
            0.5, True, torch.device("cpu"), time.perf_counter(), cell.reference())
    cell.driver().run(r)
    names = {name[len(spans.PREFIX):] for name, _, _ in r.host_segment.host
             if name.startswith(spans.PREFIX)}
    assert {"moe.route", "moe.experts", "moe.combine", "moe.backward",
            "train.forward", "train.backward", "train.optimizer"} <= names
    for m in cell.metrics(trace=True):
        value = cell.reader(m["name"]).read(r)
        assert value is None or value > 0, (m["name"], value)
    assert set(cell.limits) <= set(r.readings)


def _card_run() -> Run:
    """A run of the cell at its own sizes whose two traced steps and one
    host-traced step look as the card's do: per step the grouped expert
    products (36 kernels, 40 ms), five flash backwards (three kernels each,
    10 ms), AdamW's two kernels (25 ms), other kernels, the MoE's spans with
    their launches; 20 untraced steps of 0.25 s."""
    cell = Cell(CELL)
    r = Run(cell.name, cell.config["model"], cell.traffic, SEED, 45.0, True,
            torch.device("cpu"), 0.0, None)
    device, host, t = [], [], 0.0
    kernels = ([("cutlass::device_kernel<GemmUniversal<GroupProblemShape<...>>>", 40e-3 / 36)]
               * 36 + [("flash_bwd_dkdv_kernel<192>", 2e-3)] * 15
               + [("adamw_norm_kernel", 5e-3), ("adamw_update_kernel", 20e-3)]
               + [("elementwise_kernel", 1e-3)] * 40)
    span_of = (["moe.experts"] * 12 + ["moe.backward"] * 24 + ["train.backward"] * 15
               + ["train.optimizer"] * 2 + ["moe.route"] * 10 + ["moe.combine"] * 10
               + ["train.forward"] * 20)
    for _ in range(2):
        for (name, dt), span in zip(kernels, span_of):
            host += [(spans.PREFIX + span, t, t + 1e-4), ("cudaLaunchKernel", t, t + 5e-5)]
            device.append((name, t + 1e-4, t + 1e-4 + dt))
            t += dt + 2e-4
    seg = tr.Segment(device, host, wall_s=t, units=[1, 2])
    r.segment, r.host_segment = seg, seg
    r.untraced, r.untraced_s = list(range(3, 23)), 20 * 0.25
    r.window_s, r.setup_s = 45.0, 30.0
    r.counts.update(train_tokens=22 * 2 * 4096, attempted=22, failed=0)
    return r


def test_every_metric_of_the_cell_reads_a_number_on_a_card_timeline():
    cell = Cell(CELL)
    r = _card_run()
    names = [m["name"] for m in cell.metrics(trace=True)]
    assert set(names) == {
        "launches_per_step.train", "idle_share.train", "flash_bwd_roofline.train",
        "adamw_launches.train", "adamw_device_ms.train", "mfu_moe.train",
        "expert_gemm_roofline.train", "moe_device_ms.train"}
    read = {n: cell.reader(n).read(r) for n in names}
    assert all(isinstance(v, float) for v in read.values()), read
    assert read["launches_per_step.train"] == 93
    assert read["adamw_launches.train"] == 2
    assert read["adamw_device_ms.train"] == pytest.approx(25.0)
    assert read["moe_device_ms.train"] == pytest.approx(40.0 + 20.0)
    least = roofline_moe_train.expert_products_s(r.model, 2, 4096)
    assert read["expert_gemm_roofline.train"] == pytest.approx(100 * least / 40e-3)
    for n in names:
        if n.endswith("roofline.train") or n.startswith("mfu"):
            assert 0 < read[n] < 100, (n, read[n])
    e2e = {m["name"]: cell.reader(m["name"]).read(r) for m in cell.metrics(trace=False)}
    assert set(e2e) == {"train_tok_s", "setup_s"} and all(v > 0 for v in e2e.values())
