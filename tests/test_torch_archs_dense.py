"""repro_torch's dense archs against repro.models on their reduced configs.

Every dense-GQA arch of the registry (command-r-35b, qwen1.5-32b,
qwen2.5-32b, qwen1.5-0.5b, rdmabox-paper-100m: GQA group sizes 1 to 2 here,
3 to 8 at full width) and mamba2-780m run the shared parity cases of
tests/torch_parity.py: conversion keeps every leaf, forward logits, and
prefill plus 8 decode steps against the reference's prefill, splice and
``decode_step``. The other archs' cases are in the files ARCHS_BY_FILE
names; together they cover ARCH_IDS.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

import torch_parity as tp  # noqa: E402
from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_reduced as ref_get_reduced  # noqa: E402
from repro.models import init_stack  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.models import init_transformer  # noqa: E402

ARCHS = tp.ARCHS_BY_FILE[Path(__file__).name]


def test_arch_files_cover_the_registry():
    archs = [a for file_archs in tp.ARCHS_BY_FILE.values() for a in file_archs]
    assert sorted(archs) == sorted(ARCH_IDS) == sorted(REF_ARCH_IDS)
    here = Path(__file__).parent
    assert all((here / name).exists() for name in tp.ARCHS_BY_FILE)


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_keeps_every_leaf(arch):
    tp.check_conversion(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    tp.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    tp.check_prefill_decode(arch)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-780m", "deepseek-v2-lite-16b",
                                  "hymba-1.5b", "qwen2-moe-a2.7b", "musicgen-large"])
def test_param_count_analytic_close_to_actual(arch):
    """Twin of tests/test_models.py::test_param_count_analytic_close_to_actual
    on the port's own modules (and the reference's tree has as many values)."""
    cfg = get_reduced(arch)
    actual = sum(p.numel() for p in init_transformer(cfg, device="cpu").parameters())
    params, _ = init_stack(jax.random.PRNGKey(0), ref_get_reduced(arch))
    assert actual == sum(np.asarray(x).size for x in jax.tree.leaves(params))
    # padded vocab + small norms: within 20%
    assert abs(actual - cfg.param_count()) / actual < 0.2, arch


def test_gqa_groups_of_the_full_width_archs():
    """The dense archs' full-width group sizes, all within the kernels' limits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    from repro_torch.kernels.paged_attention.ops import MAX_GROUP
    groups = {a: get_config(a).num_heads // get_config(a).num_kv_heads for a in ARCHS
              if a != "mamba2-780m"}
    assert groups == {"command-r-35b": 8, "qwen1.5-32b": 1, "qwen2.5-32b": 5,
                      "qwen1.5-0.5b": 1, "rdmabox-paper-100m": 3}
    assert max(groups.values()) <= MAX_GROUP
    assert all(get_config(a).head_dim in HEAD_DIMS for a in groups)
