"""repro_torch's MoE (qwen2-moe-a2.7b) against repro.models on reduced configs.

The arch runs the shared parity cases of tests/torch_parity.py with
top_k = num_experts (routing is discontinuous; tests/test_models.py pins
it so). ``moe_apply`` itself is held to the reference's at the configs' own
top_k < num_experts, with a capacity factor low enough that experts drop
pairs, in f32 (a routing or drop rule that differs shows at once): output
within 1e-5 of the largest output magnitude (max|a − b| / max(|a|, 1), the
suite's measure: outputs reach ~35, where one f32 rounding is ~2e-6 and a
64-term contraction in another order ~2e-5 absolute), aux loss within 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

import torch_parity as tp  # noqa: E402
from repro.models import init_stack  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402

from repro_torch.models import moe_apply  # noqa: E402
from repro_torch.models.moe import MoE, capacity  # noqa: E402

ARCHS = tp.ARCHS_BY_FILE[Path(__file__).name]
MOE_TOL = 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_keeps_every_leaf(arch):
    tp.check_conversion(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    tp.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    tp.check_prefill_decode(arch)


def f32_moe_pair(arch: str, **overrides):
    """(reference cfg, reference layer-0 MoE params in f32, the port's MoE
    module with the same f32 weights)."""
    cfg, port_cfg = tp.reduced(arch, **overrides)
    params, _ = init_stack(jax.random.PRNGKey(7), cfg)
    leaves = {k: np.asarray(v[0], np.float32) for k, v in params["blocks"]["moe"].items()}
    mod = MoE(port_cfg, device=torch.device("cpu")).float()
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(leaves[name]))
    assert {n for n, _ in mod.named_parameters()} == set(leaves)
    return cfg, port_cfg, {k: jnp.asarray(v) for k, v in leaves.items()}, mod


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
@torch.no_grad()
def test_moe_apply_matches_reference_with_drops(arch):
    cfg, port_cfg, ref_p, mod = f32_moe_pair(arch, capacity_factor=0.5)
    assert cfg.top_k < cfg.num_experts
    B, S = 2, 32
    x = np.random.default_rng(11).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    y_ref, aux_ref = jax.jit(lambda p, x: ref_moe.moe_apply(p, x, cfg))(ref_p, jnp.asarray(x))
    y, aux = moe_apply(mod, torch.from_numpy(x), port_cfg)
    # the capacity really drops (token, expert) pairs at this factor
    probs = torch.softmax(torch.from_numpy(x).reshape(B * S, -1) @ mod.router, dim=-1)
    per_expert = torch.bincount(torch.topk(probs, cfg.top_k).indices.reshape(-1),
                                minlength=cfg.num_experts)
    assert per_expert.max().item() > capacity(B * S, port_cfg)
    assert tp.rel_err(y_ref, y) < MOE_TOL
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=MOE_TOL, atol=MOE_TOL)


def test_capacity_matches_reference():
    for arch in ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b"):
        for cf in (0.5, 1.25, 2.0):
            cfg, port_cfg = tp.reduced(arch, capacity_factor=cf)
            for tokens in (1, 4, 7, 64, 256, 1000):
                assert capacity(tokens, port_cfg) == ref_moe._capacity(tokens, cfg)
