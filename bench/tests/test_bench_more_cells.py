"""The cells that ``bench/tests/cells_more.py`` sizes, end to end on the CPU
(the kernels' plain versions): correct, reporting their end-to-end metrics,
catching each fault the cell can have (``bench/tools/faults.py``), and
their control (the reference with float8 products) reading far above the
program and failing the same limits."""

import numpy as np
import pytest
import torch

from bench.tests.cells_more import SEED, SMALL, run_small
from bench.tools import faults

torch.set_num_threads(1)
CELLS = sorted(SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_runs_and_is_correct(cell):
    out = run_small(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert np.isfinite(c["value"]) and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_end_to_end_metrics(cell):
    out = run_small(cell, trace=False)
    names = set(out["metrics"])
    assert "setup_s" in names and len(names) >= 2, names
    for v in out["metrics"].values():
        assert v["value"] > 0


FAULTS = [("deepseek-v2-lite-16b.decode", "token_altered"),
          ("deepseek-v2-lite-16b.decode", "decode_state_unchanged"),
          ("hymba-1.5b.prefill", "token_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_small_cell_fault_is_caught(cell, fault):
    with faults.FAULTS[fault]():
        assert not run_small(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_control_reads_far_above_the_program(cell):
    """On three seeds the control's largest reading of one of the cell's
    numbers is over three times the program's largest, and the control is
    not correct at the cell's limits on any of them while the program is."""
    prog, ctl = {}, {}
    for seed in (SEED, SEED + 1, SEED + 2):
        out = run_small(cell, seed=seed, control="fp8")
        assert out["correct"], out["checks"]
        assert out["control"]["correct"] is False, out["control"]
        for k, c in out["checks"].items():
            prog[k] = max(prog.get(k, 0.0), c["value"])
            ctl[k] = max(ctl.get(k, 0.0), out["notes"]["control"][k])
    assert any(ctl[k] > 3 * prog[k] for k in prog), (prog, ctl)
