"""The small decode cells, traced on the CPU, read the program's spans."""

import pytest
import torch

from bench.tests.cells import run_small

torch.set_num_threads(1)


@pytest.mark.parametrize("cell", ["command-r-35b.decode", "hymba-1.5b.decode"])
def test_decode_cell_reads_the_program_spans(cell):
    """The host capture holds the program's spans: ``kv.plan``'s host ms a step
    is read as a number (the device readings need a device)."""
    out = run_small(cell, trace=True)
    assert out["metrics"]["plan_ms.decode"]["value"] > 0
