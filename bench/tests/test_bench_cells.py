"""Every cell end to end at a small size on the CPU (the kernels' plain
versions), and the check's answer to each fault a cell can have
(``bench/tools/faults.py``): a served token altered where it is produced,
a step that leaves its state unchanged, half of a training batch left out.
No cell runs across chips, so none can leave out an exchange between them."""

import numpy as np
import pytest
import torch

from bench.tests.cells import SMALL, run_small
from bench.tools import faults

torch.set_num_threads(1)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_and_is_correct(cell):
    out = run_small(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert np.isfinite(c["value"]) and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_end_to_end_metrics(cell):
    out = run_small(cell, trace=False)
    names = set(out["metrics"])
    assert "setup_s" in names and len(names) >= 2, names
    for v in out["metrics"].values():
        assert v["value"] > 0


FAULTS = [("command-r-35b.decode", "token_altered"), ("hymba-1.5b.decode", "token_altered"),
          ("command-r-35b.prefill", "token_altered"),
          ("command-r-35b.decode", "decode_state_unchanged"),
          ("hymba-1.5b.decode", "decode_state_unchanged"),
          ("hymba-1.5b.train", "train_state_unchanged"), ("hymba-1.5b.train", "half_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault):
    with faults.FAULTS[fault]():
        assert not run_small(cell)["correct"]
