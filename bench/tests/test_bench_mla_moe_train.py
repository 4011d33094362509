"""The DeepSeek-V2 training step against its plain reference
(``bench/reference/mla_moe_train.py``) at a small size in float32 on the
CPU, seeded random weights: two layers (``cells_more.MLA_MOE``: one dense,
one MoE of 8 experts, top-2, one shared, gates unnormalised, dropless; MLA
at R 32 with YaRN) with the sequence-wise balance loss on, one step through
``launch.steps.build_train_step`` as ``bench/drivers/train.py`` builds it.
Then the reference's blocked attention against the serving reference's, its
balance loss, the yardstick's counts at the published sizes, and the
configuration files.

Tolerances, each for its reason: the loss, 1e-6 of itself (the same f32
sums in other orders: the flash kernel's plain version by blocks with an
online softmax, grouped products against a loop over the experts); every
leaf's gradient, 1e-5 of its largest element (those orders carried back
through two layers); the updated parameters, since AdamW's first step moves
each element by lr · g/(|g| + eps), nearly ±lr whatever g's size, an
element whose gradient is near 0 may move another way on each side: at most
a quarter of lr, and more than a thousandth of lr in at most 1e-3 of a
leaf's elements."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench.lib import roofline, roofline_moe_train, spec
from bench.lib.weights import Weights
from bench.tests.cells import ROOT
from bench.tests.cells_moe_train import CELL, MODEL, SEED

torch.set_num_threads(1)
C = spec.Cell(CELL)
ref = C.reference()
serving = spec.Cell("deepseek-v2-lite-16b.decode").reference()
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5


def _sizes():
    m = {**C.config["model"], **MODEL}
    return m, Weights(ref.groups(m), ref.full_name, SEED, "cpu")


def _program(m, w):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Transformer
    model = Transformer(ModelConfig(**m), device="meta").to_empty(device="cpu")
    w.fill(dict(model.named_parameters()))
    return model.float().requires_grad_(True)


def _reference_params(w):
    return {w.full_name(g, leaf): t.float().requires_grad_(True)
            for g, _ in w.groups for leaf, t in w.group(g).items()}


def test_one_train_step_matches_the_reference():
    from repro_torch.configs.base import ModelConfig, RunConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import loss_fn
    from repro_torch.optim import adamw
    m, w = _sizes()
    opt = C.traffic["optimizer"]
    model = _program(m, w)
    rows = torch.from_numpy(np.random.default_rng(0).integers(0, m["vocab_size"], (2, 65)))
    tokens, targets = rows[:, :-1], rows[:, 1:]

    loss, parts = loss_fn(model, tokens, targets)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    params = _reference_params(w)
    with ref.exact_f32():
        want = ref.loss(params, m, tokens, targets)
        want_grads = dict(zip(params, torch.autograd.grad(want, list(params.values()))))
    assert float(parts["aux"].detach()) > 0
    assert abs(float(loss.detach()) - float(want.detach())) < LOSS_TOL * float(want.detach())
    assert set(grads) == set(want_grads)
    for n, g in grads.items():
        assert float((g - want_grads[n]).abs().max()) < GRAD_TOL * float(
            want_grads[n].abs().max()), n

    run = RunConfig(learning_rate=opt["lr"], warmup_steps=opt["warmup_steps"],
                    total_steps=opt["total_steps"], weight_decay=opt["weight_decay"],
                    grad_clip=opt["grad_clip"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = adamw.init(dict(model.named_parameters()), run)
    build_train_step(ModelConfig(**m), run)(model, state, {"tokens": tokens, "targets": targets})
    ref.adamw_step(params, want_grads, {}, opt, 1, torch.float32)
    lr = ref.lr_at(1, opt)
    for n, p in model.named_parameters():
        gap = ((p.detach() - before[n]) - (params[n].detach() - before[n])).abs()
        assert float(gap.max()) <= 0.25 * lr, n
        assert float((gap > 1e-3 * lr).float().mean()) <= 1e-3, n


def test_blocked_attention_equals_the_serving_reference():
    """Queries in blocks of 512 over the keys up to each block's end, against
    the serving reference's blocks of 1024 over every key, masked: 1,100
    tokens, so both cross their blocks' edges."""
    m, w = _sizes()
    p = {k: t.float() for k, t in w.group("blocks.0").items()}
    h = torch.randn(2, 1100, m["d_model"], generator=torch.Generator().manual_seed(1))
    with ref.exact_f32():
        got = ref.mla(p, h, m, None)
        want = serving.mla(p, h, m, None)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())


def test_balance_loss_per_sequence_and_over_the_batch():
    """With ``moe_seq_aux`` the loss is the per-sequence mean of α·Σ f_i·P_i;
    without it one sum over the batch; the two differ when the sequences
    route unevenly."""
    m, _ = _sizes()
    E, K, S = m["num_experts"], m["top_k"], 8
    idx = torch.tensor([[0, 1]] * S + [[e % E, (e + 3) % E] for e in range(S)])
    probs = torch.softmax(torch.zeros(2 * S, E).scatter_(1, idx, 2.0), -1)
    f0 = torch.bincount(idx[:S].reshape(-1), minlength=E) * E / (K * S)
    f1 = torch.bincount(idx[S:].reshape(-1), minlength=E) * E / (K * S)
    want = 0.001 * 0.5 * float((f0 * probs[:S].mean(0)).sum() + (f1 * probs[S:].mean(0)).sum())
    assert float(ref.balance_loss(probs, idx, m, 2)) == pytest.approx(want, rel=1e-6)
    batch = float(ref.balance_loss(probs, idx, {**m, "moe_seq_aux": False}, 2))
    assert want > 1.1 * batch


def test_step_counts_at_the_published_sizes():
    """The cell's step: 33.69 TFLOP of bf16 products (6·N·D of 623 M active
    parameters at 8,192 tokens, 30.6 TFLOP, and causal MLA's 3.09), 68.16 GB
    of parameters, gradients and moments; least time 34.12 ms, its
    operations'. The nine grouped products of each MoE layer: 283.4 GFLOP
    each, 10.32 ms in all at their bounds."""
    m = C.config["model"]
    flops, f32, nbytes = roofline_moe_train.train_step(m, 2, 4096)
    assert flops / 1e12 == pytest.approx(33.695, abs=1e-3)
    assert 6 * 8192 * roofline_moe_train.active_params(m)[0] / 1e12 == pytest.approx(30.60, abs=0.01)
    assert 5 * roofline_moe_train.attention_flops(m, 2, 4096) / 1e12 == pytest.approx(3.093, abs=1e-3)
    assert f32 == 6 * 8192 * 4 * 2048 * 64
    assert nbytes / 1e9 == pytest.approx(68.156, abs=1e-3)
    assert roofline.least_s((flops, f32, nbytes)) * 1e3 == pytest.approx(34.12, abs=0.01)
    products = roofline_moe_train.expert_products(m, 2, 4096)
    assert len(products) == 9 * 4 and all(p[0] == 2 * 49152 * 2048 * 1408 for p in products)
    assert roofline_moe_train.expert_products_s(m, 2, 4096) * 1e3 == pytest.approx(10.32, abs=0.01)
    from repro_torch.configs import get_config
    stage = get_config("deepseek-v2-lite-5l")
    # the program's analytic count leaves out kv_norm (512 a layer) and final_norm
    assert roofline_moe_train.params_total(m) - stage.param_count() == 5 * 512 + 2048


def test_configuration_files():
    """The new file's ``model`` is the program's ``STAGE`` field for field, its
    release keys the published file's but for ``num_hidden_layers`` (the one
    key in ``reduced``); the three configurations the benchmark had build the
    models they did."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.deepseek_v2_lite_16b import PUBLISHED
    cfg = C.config
    assert ModelConfig(**cfg["model"]) == get_config("deepseek-v2-lite-5l")
    entry = {c["name"]: c for c in spec.benchmark()["configs"]}["deepseek-v2-lite-5l"]
    assert entry["reduced"] == ["num_hidden_layers"]
    with open(f"{ROOT}/bench/configs/deepseek-v2-lite-16b.json") as f:
        published = json.load(f)
    release = {k for k in published if k not in ("name", "deployment", "reference", "dtype",
                                                 "published", "model", "reduced", "assumed")}
    assert {k for k in release if published[k] != cfg[k]} == {"num_hidden_layers"}
    assert cfg["num_hidden_layers"] == 5 and cfg["model"]["moe_seq_aux"] is True
    counts = {"command-r-35b": 30_283_530_240, "hymba-1.5b": 1_640_249_600,
              "deepseek-v2-lite-16b": 15_706_468_352}
    for name, n in counts.items():
        model = ModelConfig(**spec.Cell(next(w["name"] for w in spec.benchmark()["workloads"]
                                             if w["config"] == name)).config["model"])
        assert model.param_count() == n and not model.moe_seq_aux
    assert ModelConfig(**published["model"]) == PUBLISHED


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys, importlib.util\n"
            "spec = importlib.util.spec_from_file_location('ref', "
            "'bench/reference/mla_moe_train.py')\n"
            "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro_torch', 'repro', 'jax', 'bench'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
