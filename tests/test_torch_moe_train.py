"""The dropless MoE's training path (``models/moe.py``): its backward of its
own (``_DroplessExperts``) against autograd's of the same forward, its
repeats, the sequence-wise balance loss (``moe_seq_aux``) against the
release's formula, the routing counters after ``launch.train``, and the
published DeepSeek-V2-Lite stage (``configs/deepseek_v2_lite_16b.STAGE``).

Tolerances: on the CPU in f32 the function's backward and autograd's sum
the same f32 products in other orders (the token's K rows in order of k
against an accumulate over repeated rows; the SwiGLU's derivative in f32
against autograd's chain), so they agree within 1e-6 of each gradient's
largest element. On the card in bf16 autograd rounds each of its partial
sums to bf16 (the accumulate over a token's 6 rows, dh·W_iᵀ + dg·W_gᵀ),
where the function sums in f32 and rounds once: about one bf16 rounding
(2⁻⁸ = 3.9e-3) of each gradient's norm, carried back through five layers.

The cases marked ``gpu`` in their names skip without a card; on one:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_moe_train.py -k gpu
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, all_configs, get_config, get_reduced, replace
from repro_torch.models import Transformer, loss_fn
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import MoE, _route, _seq_aux, moe_apply

torch.set_num_threads(1)
CPU_TOL = 1e-6            # f32 gradients, the same products in another order
CARD_TOL = 2e-2           # bf16 gradients, autograd's roundings (module docstring)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _layer(device="cpu", dtype=torch.float32, cfg=None, seed=7):
    cfg = cfg or get_reduced("deepseek-v2-lite-5l")
    p = MoE(cfg, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, t in p.named_parameters():
            fan_in = t.shape[-2] if t.ndim == 3 else t.shape[0]
            t.copy_(torch.randn(t.shape, generator=g, device=device) * fan_in ** -0.5)
    p = p.to(dtype)
    p.router.data = p.router.data.float()
    return cfg, p.requires_grad_(True)


def _grads(p, x, cfg, dy):
    """(y, aux, [dx, every parameter's gradient]) of (y·dy).sum() + aux."""
    x = x.detach().requires_grad_(True)
    p.zero_grad(set_to_none=True)
    y, aux = moe_apply(p, x, cfg)
    ((y.float() * dy).sum() + aux).backward()
    return y.detach(), aux.detach(), [x.grad] + [t.grad for t in p.parameters()]


def _plain(monkeypatch):
    """Autograd of the same forward in place of the function's backward."""
    monkeypatch.setattr(moe_mod._DroplessExperts, "apply",
                        lambda *a: moe_mod._experts(*a)[0])


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def test_dropless_backward_equals_autograd_of_the_same_forward(monkeypatch):
    cfg, p = _layer()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 40, cfg.d_model, generator=gen)
    dy = torch.randn(3, 40, cfg.d_model, generator=gen)
    y, aux, ours = _grads(p, x, cfg, dy)
    _plain(monkeypatch)
    y2, aux2, theirs = _grads(p, x, cfg, dy)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)          # the forward is the same
    names = ["x"] + [n for n, _ in p.named_parameters()]
    for n, a, b in zip(names, ours, theirs):
        assert _rel(a, b) < CPU_TOL, n
    assert all(g.abs().sum() > 0 for g in ours)                   # every input moved


def test_dropless_backward_repeats_bit_for_bit():
    cfg, p = _layer(dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 48, cfg.d_model, generator=gen).bfloat16()
    dy = torch.randn(2, 48, cfg.d_model, generator=gen)
    a, b = _grads(p, x, cfg, dy), _grads(p, x, cfg, dy)
    assert all(torch.equal(u, v) for u, v in zip(a[2], b[2]))


def test_serving_runs_the_plain_forward_and_no_balance_loss(monkeypatch):
    """Under ``no_grad`` the layer runs ``_experts`` alone (the function is
    never entered) and the sequence-wise loss is not computed (0)."""
    cfg, p = _layer()
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(moe_mod._DroplessExperts, "apply",
                        lambda *a: pytest.fail("the function ran under no_grad"))
    with torch.no_grad():
        y, aux = moe_apply(p, x, cfg)
    assert float(aux) == 0.0 and y.shape == x.shape


def _hand_made(seqs=2, S=6, E=4, K=2):
    """Picks and probabilities where the two sequences route unevenly: the
    first sends every token to experts 0 and 1, the second spreads."""
    idx = torch.tensor([[0, 1]] * S + [[0, 1], [2, 3], [1, 2], [3, 0], [2, 1], [0, 3]])
    noise = torch.randn(seqs * S, E, generator=torch.Generator().manual_seed(4))
    picked = torch.zeros(seqs * S, E).scatter_(1, idx, 1.0)
    return idx, torch.softmax(2 * picked + 0.1 * noise, -1)   # each token favours its picks


def test_sequence_aux_is_the_releases_formula():
    """α·Σ_i f_i·P_i averaged over the sequences, f_i = E/(K·S)·picks,
    P_i = the sequence's mean probability, as the release's MoEGate computes
    it (``ce.scatter_add_(...).div_(seq_len * aux_topk / n_routed_experts)``)."""
    cfg = get_reduced("deepseek-v2-lite-5l")
    idx, probs = _hand_made()
    E, K, S, alpha = 4, 2, 6, cfg.router_aux_weight
    want = 0.0
    for b in range(2):
        picks = torch.bincount(idx[b * S:(b + 1) * S].reshape(-1), minlength=E).float()
        want += alpha * float((picks * E / (K * S) * probs[b * S:(b + 1) * S].mean(0)).sum())
    want /= 2
    cfg4 = replace(cfg, num_experts=E, top_k=K)
    with torch.enable_grad():
        got = _seq_aux(probs.clone().requires_grad_(True), idx, 2, cfg4).detach()
    assert float(got) == pytest.approx(want, rel=1e-6)
    # the batch-wide loss over the same picks is another number: the first
    # sequence's imbalance is averaged away by the second's spread
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    batch = alpha * E * float((probs.mean(0) * counts / (12 * K)).sum())
    assert want > 1.1 * batch          # 16 % above it here


def test_route_takes_the_sequence_wise_loss_only_with_the_flag():
    cfg, p = _layer()
    x = torch.randn(48, cfg.d_model, generator=torch.Generator().manual_seed(5))
    off = replace(cfg, moe_seq_aux=False)
    with torch.enable_grad():
        p.router.requires_grad_(True)
        _, idx, counts, aux_seq = _route(x, p, cfg, 2)
        _, _, _, aux_batch = _route(x, p, off, 2)
        probs = torch.softmax(x @ p.router.detach(), -1).requires_grad_(True)
        want_seq = float(_seq_aux(probs, idx, 2, cfg))
    E, K = cfg.num_experts, cfg.top_k
    assert float(aux_batch) == pytest.approx(
        float(cfg.router_aux_weight * E * (probs.mean(0) * counts / (48 * K)).sum()), rel=1e-6)
    assert float(aux_seq) == pytest.approx(want_seq, rel=1e-6) and want_seq > 0
    assert aux_seq.requires_grad and float(aux_seq) != float(aux_batch)


def test_routing_counters_after_training(capsys, tmp_path):
    """``launch.train`` on the stage's small twin prints ``routing:`` after its
    loop; each MoE layer took every (token, expert) pair of every step."""
    from repro_torch.launch import train
    res = train.main(["--arch", "deepseek-v2-lite-5l", "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "32", "--ckpt-every", "100",
                      "--ckpt-dir", str(tmp_path)])
    cfg = get_reduced("deepseek-v2-lite-5l")
    snap = res.model.routing_snapshot()
    assert set(snap) == {1}
    pairs = 3 * 2 * 32 * cfg.top_k
    assert snap[1]["pairs"] == pairs and snap[1]["dropped"] == 0
    assert snap[1]["mean"] == pairs / cfg.num_experts and snap[1]["most"] >= snap[1]["mean"]
    assert "routing: {1: {'pairs': 384" in capsys.readouterr().out
    assert np.all(np.isfinite(res.losses))


def test_the_published_stage():
    """``STAGE``: the published model's first five layers with the
    sequence-wise loss, 2.840 B parameters, 623 M active a token without the
    embedding table; outside the reference's list of archs."""
    stage = get_config("deepseek-v2-lite-5l")
    published = get_config("deepseek-v2-lite-16b")
    assert "deepseek-v2-lite-5l" not in ARCH_IDS
    assert stage.num_layers == 5 and stage.first_dense_layers == 1 and stage.moe_seq_aux
    assert stage.param_count() == 2_839_826_432
    active = stage.active_param_count() - stage.vocab_size * stage.d_model
    assert active == 623_136_768
    assert not published.moe_seq_aux
    model = Transformer(stage, device="meta")
    assert [b.moe is not None for b in model.blocks] == [False, True, True, True, True]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_registry_config_builds_as_before(arch):
    """The new field is off everywhere it was not asked for, and each model
    still builds (on the meta device) with the parameters it counts."""
    for cfg in (all_configs()[arch], get_reduced(arch)):
        assert cfg.moe_seq_aux is False
        n = sum(p.numel() for p in Transformer(cfg, device="meta").parameters())
        assert n >= cfg.param_count() * 0.99


def test_stage_small_twin_trains_through_the_function():
    """A reduced stage's loss and backward reach every parameter, the
    routers and experts through ``_DroplessExperts``."""
    cfg = get_reduced("deepseek-v2-lite-5l")
    from repro_torch.models import init_transformer
    model = init_transformer(cfg, seed=0, device="cpu").float().requires_grad_(True)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    loss, metrics = loss_fn(model, tok, tok.roll(-1, 1))
    loss.backward()
    assert float(metrics["aux"]) > 0
    for n, p in model.named_parameters():
        if n != "embed":
            assert p.grad is not None and p.grad.abs().sum() > 0, n


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def test_dropless_backward_repeats_bit_for_bit_at_the_cells_shapes_on_gpu(cuda):
    """One MoE layer of the published stage at 2 × 4096 tokens (8,192 tokens,
    64 experts, top-6: 768 rows an expert): two forwards and backwards give
    equal bits in the output, the balance loss and every gradient."""
    cfg, p = _layer(cuda, torch.bfloat16, get_config("deepseek-v2-lite-5l"))
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(2, 4096, cfg.d_model, generator=gen, device=cuda).bfloat16()
    dy = torch.randn(2, 4096, cfg.d_model, generator=gen, device=cuda)
    a, b = _grads(p, x, cfg, dy), _grads(p, x, cfg, dy)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(u, v) for u, v in zip(a[2], b[2]))


def test_stage_step_against_autograd_of_the_plain_forward_on_gpu(cuda, monkeypatch):
    """The published stage (five layers, every width as released) at 2 × 4096
    tokens in bf16, seeded random weights: the loss and every leaf's gradient
    through ``_DroplessExperts`` against autograd's of the same forward, by
    each leaf's norm (``CARD_TOL``); twice through the function, equal bits."""
    from repro_torch.models import init_transformer
    cfg = get_config("deepseek-v2-lite-5l")
    model = init_transformer(cfg, seed=0, device=cuda).requires_grad_(True)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4097))).to(cuda)

    def run():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, rows[:, :-1], rows[:, 1:])
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    loss_a, ga = run()
    loss_b, gb = run()
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)
    del gb
    _plain(monkeypatch)
    loss_c, gc = run()
    assert torch.equal(loss_a, loss_c)                             # the same forward
    worst, leaf = max((((ga[n].float() - gc[n].float()).norm() / gc[n].float().norm()).item(), n)
                      for n in ga if gc[n].float().norm() > 0)
    print(f"stage gradients, function against autograd: worst leaf {leaf} {worst:.3e}")
    assert worst < CARD_TOL
