"""repro_torch's frontend archs (musicgen-large, llava-next-34b) against
repro.models on their reduced configs.

Their modality frontends are stubs in the reference: the backbone takes
precomputed embeddings (B, S, M) for a prompt and (B, M) for a decode step,
cast to the embedding dtype. Both packages get the same standard-normal
embeddings from numpy and run the shared parity cases of
tests/torch_parity.py.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

import torch_parity as tp  # noqa: E402

ARCHS = tp.ARCHS_BY_FILE[Path(__file__).name]


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_keeps_every_leaf(arch):
    tp.check_conversion(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    tp.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    tp.check_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
@torch.no_grad()
def test_embeddings_are_cast_to_the_table_dtype(arch):
    """f32 embeddings give the same logits as the same values rounded to
    bf16 first: the model casts them, as the reference's ``astype`` does;
    a decode step takes (B, M) the same way."""
    cfg, _, model = tp.models(arch)
    x = torch.from_numpy(tp.inputs(cfg, 5, 2, 8))
    np.testing.assert_array_equal(model(x).float().numpy(), model(x.bfloat16()).float().numpy())
    cache = model.init_cache(2, 9)
    model.prefill(x, cache)
    step = model.decode_step(cache, x[:, 0], np.full(2, 8))
    assert step.shape == (2, cfg.padded_vocab) and torch.isfinite(step).all()
