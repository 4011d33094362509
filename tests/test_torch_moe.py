"""repro_torch's MoE (qwen2-moe-a2.7b) against repro.models on reduced configs.

The arch runs the shared parity cases of tests/torch_parity.py with
top_k = num_experts (routing is discontinuous; tests/test_models.py pins
it so). ``moe_apply`` itself is held to the reference's at the configs' own
top_k < num_experts, with a capacity factor low enough that experts drop
pairs, in f32 (a routing or drop rule that differs shows at once): output
within 1e-5 of the largest output magnitude (max|a − b| / max(|a|, 1), the
suite's measure: outputs reach ~35, where one f32 rounding is ~2e-6 and a
64-term contraction in another order ~2e-5 absolute), aux loss within 1e-5.

The layer's combine and the dispatch's backward are gathers summed over each
token's K slots in a fixed order (no ``index_add_``, no accumulate over
repeated rows): held here to the autograd of the scatter-add they replace, and
on the card (the case marked ``gpu`` in its name; it skips without one) to
equal bits across two forwards and backwards. JAX is imported only where it is
installed, so on a GPU machine without it:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_moe.py -k gpu
"""

from pathlib import Path

import numpy as np
import pytest

try:                  # the reference; a GPU machine without JAX runs the card case alone
    import jax
    import jax.numpy as jnp
except ModuleNotFoundError:
    jax = jnp = None

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

if jax is not None:
    import torch_parity as tp
    from repro.models import init_stack
    from repro.models import moe as ref_moe

from repro_torch.models import moe_apply  # noqa: E402
from repro_torch.models.moe import MoE, _Combine, _Dispatch, _slots, capacity  # noqa: E402

ARCHS = tp.ARCHS_BY_FILE[Path(__file__).name] if jax is not None else []
MOE_TOL = 1e-5
reference = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


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


@reference
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


@reference
def test_capacity_matches_reference():
    for arch in ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b"):
        for cf in (0.5, 1.25, 2.0):
            cfg, port_cfg = tp.reduced(arch, capacity_factor=cf)
            for tokens in (1, 4, 7, 64, 256, 1000):
                assert capacity(tokens, port_cfg) == ref_moe._capacity(tokens, cfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_gathers_match_the_scatter_add_they_replace(seed):
    """_Combine and _Dispatch against ``index_add_`` and ``xt[src]`` under
    autograd, at a routing that drops pairs: the same sums (to f32 rounding;
    the order differs), and the same gradient where it is a gather."""
    rng = np.random.default_rng(seed)
    T, K, E, M = 37, 4, 6, 5
    C = 16                                         # < T·K / E: experts drop pairs
    expert_idx = torch.from_numpy(np.argsort(rng.random((T, E)), axis=1)[:, :K].copy())
    order, valid, slot, src, occupied, slot_map = _slots(expert_idx, E, C)
    assert not valid.all() and occupied.sum() == valid.sum()
    assert (slot_map == E * C).sum() == (~valid).sum()
    kept = slot_map[slot_map < E * C]
    assert torch.equal(kept.sort().values, torch.nonzero(occupied).flatten())
    mask = occupied[:, None].float()

    contrib = torch.from_numpy(rng.normal(size=(E * C, M))).float()
    dy = torch.from_numpy(rng.normal(size=(T, M))).float()
    a, b = contrib.clone().requires_grad_(), contrib.clone().requires_grad_()
    y = _Combine.apply(a, slot_map, src, occupied)
    y_ref = torch.zeros(T, M).index_add_(0, src, b * mask)
    torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=1e-6)
    y.backward(dy)
    y_ref.backward(dy)
    assert torch.equal(a.grad, b.grad)

    xt = torch.from_numpy(rng.normal(size=(T, M))).float()
    dg = torch.from_numpy(rng.normal(size=(E * C, M))).float()
    a, b = xt.clone().requires_grad_(), xt.clone().requires_grad_()
    g = _Dispatch.apply(a, src, occupied, slot_map)
    g_ref = b[src] * mask
    assert torch.equal(g, g_ref)
    g.backward(dg)
    g_ref.backward(dg)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def test_moe_forward_and_backward_repeat_bit_for_bit_on_gpu(cuda):
    """Reduced qwen2-moe-a2.7b (top_k < num_experts): the loss and every
    parameter's gradient equal in every bit across two forward and backward
    runs on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_transformer, loss_fn
    cfg = get_reduced("qwen2-moe-a2.7b")
    assert cfg.top_k < cfg.num_experts
    model = init_transformer(cfg, seed=0, device=cuda).requires_grad_(True)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).to(cuda)
    targets = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).to(cuda)
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, tokens, targets)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach().clone(),
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}))
    (loss_a, ga), (loss_b, gb) = runs
    assert torch.equal(loss_a, loss_b)
    assert set(ga) == set(gb) and any(".moe." in n for n in ga)
    for name, g in ga.items():
        assert torch.equal(g, gb[name]), name
