"""The DeepSeek-V2 path against its plain reference (``bench/reference/mla_moe.py``)
at a small size in float32 on the CPU, seeded random weights: two layers,
one dense and one MoE (8 experts, top-2, one shared, gates unnormalised,
dropless), MLA at R 32 with YaRN on. Then the dropless dispatch against a
loop over the experts, YaRN's table at the published values, and the
yardstick's counts at the published sizes.

Tolerances: the program and the reference compute the same f32 products in
other orders (the flash kernel's plain version by blocks with an online
softmax, the absorbed decode's W_kb folded into the query, grouped products
against per-expert ones), so they differ by f32 rounding carried through two
layers: 1e-4 of the largest logit, as bench/tests/test_bench_reference.py
holds the decoder; the MoE layer alone 1e-5 of its largest output."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from bench.lib import roofline, roofline_moe, spec
from bench.lib.weights import Weights
from bench.tests.cells import ROOT
from bench.tests.cells_more import MLA_MOE, SEED

torch.set_num_threads(1)
CELL = spec.Cell("deepseek-v2-lite-16b.decode")
ref = CELL.reference()
LOGIT_TOL = 1e-4          # f32 against f32 in another order, two layers
LAYER_TOL = 1e-5          # one MoE layer, f32 in another order


def _model(sizes=MLA_MOE, seed=SEED):
    """(config dict, Weights, the program's model in f32) at ``sizes``."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Transformer
    m = {**CELL.config["model"], **sizes}
    w = Weights(ref.groups(m), ref.full_name, seed, "cpu")
    model = Transformer(ModelConfig(**m), device="meta").to_empty(device="cpu")
    w.fill(dict(model.named_parameters()))
    return m, w, model.float()


def _err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_model_has_a_dense_layer_then_the_moe():
    m, _, model = _model()
    assert model.blocks[0].mlp is not None and model.blocks[0].moe is None
    assert model.blocks[1].mlp is None and model.blocks[1].moe is not None
    assert model.blocks[1].moe.router.dtype == torch.float32


def test_prefill_and_forward_equal_the_reference():
    m, w, model = _model()
    S = 80
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, m["vocab_size"], (2, S)))
    want = ref.logits_at(w.group, m, tokens, [list(range(S))] * 2)
    with torch.no_grad():
        full = model(tokens)[..., : m["vocab_size"]]
        last = model.prefill(tokens, model.init_cache(2, S))[:, : m["vocab_size"]]
    for b in range(2):
        assert _err(full[b], want[b]) < LOGIT_TOL
        assert _err(last[b], want[b][-1]) < LOGIT_TOL


def test_decode_through_the_latent_cache_equals_the_full_forward():
    """Prefill 48 tokens, then decode 24 more one at a time through the
    ``LatentCache`` (absorbed decode): every position's logits equal the
    reference's full forward over the whole sequence."""
    m, w, model = _model()
    P, S = 48, 72
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, m["vocab_size"], (2, S)))
    want = ref.logits_at(w.group, m, tokens, [list(range(S))] * 2)
    with torch.no_grad():
        cache = model.init_cache(2, S)
        got = [model.prefill(tokens[:, :P], cache)]
        for i in range(P, S):
            got.append(model.decode_step(cache, tokens[:, i], np.full(2, i)))
    for k, i in enumerate(range(P - 1, S)):
        for b in range(2):
            assert _err(got[k][b, : m["vocab_size"]], want[b][i]) < LOGIT_TOL, (i, b)


def _moe(sizes=None, **flags):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.moe import MoE
    m = {**CELL.config["model"], **MLA_MOE, **(sizes or {}), **flags}
    cfg = ModelConfig(**m)
    p = MoE(cfg, device="cpu").float()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, t in p.named_parameters():
            fan_in = t.shape[-2] if t.ndim == 3 else t.shape[0]
            t.copy_(torch.randn(t.shape, generator=g) * fan_in ** -0.5)
    return cfg, p


def _loop(cfg, p, x, normalise):
    """Every token through each expert it picks, one expert at a time."""
    f = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(f @ p.router, -1)
    gate, idx = torch.topk(probs, cfg.top_k, -1)
    if normalise:
        gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(f)
    for e in range(cfg.num_experts):
        tok, k = torch.nonzero(idx == e, as_tuple=True)
        h = (f[tok] @ p.wi[e]) * torch.nn.functional.silu(f[tok] @ p.wg[e])
        y[tok] += (h @ p.wo[e]) * gate[tok, k][:, None]
    sh = (f @ p.shared_wi) * torch.nn.functional.silu(f @ p.shared_wg)
    return (y + sh @ p.shared_wo).view(x.shape)


@pytest.mark.parametrize("normalise", [False, True])
def test_dropless_moe_equals_a_loop_over_the_experts(normalise):
    from repro_torch.models.moe import moe_apply
    cfg, p = _moe(norm_topk_prob=normalise)
    x = torch.randn(3, 40, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, _ = moe_apply(p, x, cfg)
    want = _loop(cfg, p, x, normalise)
    assert _err(y, want) < LAYER_TOL
    if not normalise:    # renormalised gates are another layer
        assert _err(_loop(cfg, p, x, True), want) > 1e-2


def test_dropless_keeps_every_pair_when_every_token_picks_the_same_experts():
    """A router that sends all 120 tokens to experts 0 and 1: the dropless
    layer keeps all 240 pairs (the counter: 120 each, none dropped) and
    equals the loop; the capacity dispatch at the same size drops pairs."""
    from repro_torch.models.moe import moe_apply
    x = torch.randn(3, 40, MLA_MOE["d_model"], generator=torch.Generator().manual_seed(2)).abs()
    outs = {}
    for dropless in (True, False):
        cfg, p = _moe(moe_dropless=dropless)
        with torch.no_grad():
            p.router.zero_()
            p.router[:, 0], p.router[:, 1] = 1.0, 0.9
            outs[dropless] = (moe_apply(p, x, cfg)[0], p.snapshot(), p.routed.clone())
    y, snap, routed = outs[True]
    assert routed[:2].tolist() == [120, 120] and int(routed[2:-1].sum()) == 0
    assert snap == {"pairs": 240, "most": 120, "mean": 30.0, "dropped": 0}
    assert _err(y, _loop(cfg, p, x, False)) < LAYER_TOL
    assert outs[False][1]["dropped"] > 0


def test_dropless_repeats_bit_for_bit():
    from repro_torch.models.moe import moe_apply
    cfg, p = _moe()
    x = torch.randn(2, 33, cfg.d_model, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a, b = moe_apply(p, x, cfg)[0], moe_apply(p, x, cfg)[0]
    assert torch.equal(a, b)


def test_gates_are_the_routers_probabilities_when_not_normalised():
    from repro_torch.models.moe import _route
    cfg, p = _moe(norm_topk_prob=False)
    x = torch.randn(50, cfg.d_model, generator=torch.Generator().manual_seed(4))
    gate, idx, counts, _ = _route(x, p, cfg)
    probs = torch.softmax(x @ p.router, dim=-1)
    assert torch.equal(gate, probs.gather(-1, idx))
    assert counts.sum() == 50 * cfg.top_k
    assert float(gate.sum(-1).max()) < 0.999
    cfg_n, _ = _moe(norm_topk_prob=True)
    gate_n, _, _, _ = _route(x, p, cfg_n)
    assert torch.allclose(gate_n.sum(-1), torch.ones(50))


def test_yarn_table_at_the_published_values():
    """Low 10, high 23 over qk_rope 64; m = 0.1·0.707·ln 40 + 1, m² 1.5897;
    the cos/sin scale 1; frequencies θ^(−2i/64) below the ramp, divided by
    40 above it, and the port's table equal to the reference's."""
    import math

    from repro_torch.configs.deepseek_v2_lite_16b import PUBLISHED
    from repro_torch.models.layers import (softmax_scale, yarn_attn_factor, yarn_freqs,
                                           yarn_range)
    m = CELL.config["model"]
    assert yarn_range(64, PUBLISHED) == (10, 23) == ref.yarn_bounds(m, 64)
    assert yarn_attn_factor(PUBLISHED) == pytest.approx(1.5897, abs=1e-4)
    assert yarn_attn_factor(PUBLISHED) == pytest.approx((0.1 * 0.707 * math.log(40) + 1) ** 2)
    assert softmax_scale(PUBLISHED, 192) == pytest.approx(192 ** -0.5 * 1.5896, rel=1e-4)
    assert ref.score_scale(m) == softmax_scale(PUBLISHED, 192)
    f = yarn_freqs(64, PUBLISHED).double()
    base = 1e4 ** (-torch.arange(32, dtype=torch.float64) / 32)
    assert torch.allclose(f[:11], base[:11], rtol=1e-6)
    assert torch.allclose(f[23:], base[23:] / 40, rtol=1e-6)
    ramp = (torch.arange(32, dtype=torch.float64) - 10) / 13
    mid = base / 40 * ramp + base * (1 - ramp)
    assert torch.allclose(f[10:24], mid[10:24], rtol=1e-6)
    cos, sin = ref.rope_table(m, 64, 3000, "cpu")
    pos = torch.arange(3000, dtype=torch.float64)[:, None]
    assert torch.allclose(cos, (pos * f[None]).cos().float(), atol=2e-4)
    assert torch.allclose(sin, (pos * f[None]).sin().float(), atol=2e-4)


def test_plain_rope_is_unchanged_without_yarn():
    from repro_torch.configs import get_config
    from repro_torch.models.layers import apply_rope, rope
    cfg = get_config("deepseek-v2-lite-16b")
    x = torch.randn(2, 9, 3, 64)
    pos = torch.arange(9).expand(2, 9)
    assert torch.equal(rope(x, pos, cfg), apply_rope(x, pos, cfg.rope_theta))


def test_published_config_counts():
    from repro_torch.configs.deepseek_v2_lite_16b import CONFIG, PUBLISHED
    assert PUBLISHED.param_count() == 15_706_468_352             # 15.71 B
    active = PUBLISHED.active_param_count() - PUBLISHED.vocab_size * PUBLISHED.d_model
    assert active / 1e9 == pytest.approx(2.45, abs=5e-3)       # without the embedding table
    assert PUBLISHED.moe_layers == 26 and CONFIG.moe_layers == 27


def test_step_counts_at_the_published_sizes():
    """At B 64: 28.74 GB of routed expert weights a step (63.9 of 64 experts a
    layer touched, 26 layers); at 1,536 live tokens a sequence the step's
    least time is 10.15 ms, its bytes'."""
    m = CELL.config["model"]
    assert roofline_moe.experts_touched(m, 64) == pytest.approx(63.88, abs=0.01)
    assert roofline_moe.expert_bytes(m, 64) / 1e9 == pytest.approx(28.74, abs=0.005)
    work = roofline_moe.decode_step(m, [1536] * 64)
    assert roofline.least_s(work) * 1e3 == pytest.approx(10.15, abs=0.01)
    assert work[2] / roofline.HBM_BW > work[0] / roofline.PEAK_BF16
    flops, _, nbytes = roofline_moe.expert_products(m, 64)
    assert flops == 26 * 2 * 64 * 6 * 3 * 2048 * 1408
    assert nbytes == pytest.approx(28.74e9 + 26 * 2 * 64 * 6 * 2048 * 2, rel=1e-3)
    assert roofline_moe.decode_step(m, [2000] * 64)[2] > work[2]


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys, importlib.util\n"
            "spec = importlib.util.spec_from_file_location('ref', 'bench/reference/mla_moe.py')\n"
            "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro_torch', 'repro', 'jax', 'bench'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
