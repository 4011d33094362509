"""The port's training forward, ``loss_fn`` and gradients against the reference.

Both packages run the reference's weights (``init_stack`` through
``from_reference_params``, with the constant leaves redrawn as in
tests/torch_parity.py). On the CPU every kernel wrapper runs its plain
version; flash attention goes through its ``autograd.Function``, whose
backward is the backward kernel's plain version.

- ``loss_fn`` in f32 on both sides: loss, nll and aux each within 1e-5
  relative, with masked targets, a padded vocabulary and a MoE (aux ≠ 0);
  the twin of tests/test_models.py::test_loss_masks_negative_targets.
- Every arch of ARCH_IDS: in bf16, as the reference runs it, a finite loss
  and a finite, nonzero gradient norm (the twin of
  tests/test_models.py::test_arch_train_step_smoke); in f32 on both sides,
  each parameter's gradient within ‖g_port − g_ref‖ / ‖g_ref‖ ≤ 1e-3 of
  ``jax.grad``'s, read back into a second port model through
  ``from_reference_params``. Same weights and f32 hold the MoE's top-k
  routing fixed.
- ``remat="full"`` gives the gradients of ``"none"`` to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

import torch_parity as tp  # noqa: E402
from repro.models import loss_fn as ref_loss_fn  # noqa: E402

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.models import from_reference_params, init_transformer, loss_fn  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
REMAT_TOL = 1e-6
B, S = 2, 32


def f32_models(arch: str, **overrides):
    """(reference cfg, the reference's f32 params, the port's f32 model), same weights."""
    cfg, params, _ = tp.models(arch, **overrides)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    _, port_cfg = tp.reduced(arch, **overrides)
    model = from_reference_params(jax.tree.map(np.asarray, p32), port_cfg, device="cpu",
                                  dtype=torch.float32)
    return cfg, p32, model


def batch(cfg, seed: int):
    x = tp.inputs(cfg, seed, B, S)
    targets = np.random.default_rng(seed + 100).integers(0, cfg.vocab_size, (B, S))
    return x, targets.astype(np.int32)


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.mark.parametrize("arch,overrides", [
    ("rdmabox-paper-100m", {}),
    ("rdmabox-paper-100m", {"vocab_size": 500}),   # padded_vocab 512 ≠ vocab_size
    ("qwen2-moe-a2.7b", {}),                         # aux ≠ 0
    ("mamba2-780m", {}),
])
def test_loss_matches_reference(arch, overrides):
    cfg, p32, model = f32_models(arch, **overrides)
    assert (cfg.padded_vocab != cfg.vocab_size) == ("vocab_size" in overrides)
    x, targets = batch(cfg, 5)
    targets[:, ::5] = -100                           # masked positions
    ref_loss, ref_m = jax.jit(lambda p, t, y: ref_loss_fn(p, t, y, cfg))(
        p32, jnp.asarray(x), jnp.asarray(targets))
    with torch.no_grad():
        loss, m = loss_fn(model, tp.to_torch(x), torch.from_numpy(targets).long())
    assert rel(loss, ref_loss) <= LOSS_TOL
    assert rel(m["nll"], ref_m["nll"]) <= LOSS_TOL
    if cfg.num_experts:
        assert float(ref_m["aux"]) > 0 and rel(m["aux"], ref_m["aux"]) <= LOSS_TOL
    else:
        assert float(m["aux"]) == 0.0 == float(ref_m["aux"])


def test_loss_masks_negative_targets():
    """Twin of tests/test_models.py::test_loss_masks_negative_targets."""
    cfg, _, model = tp.models("qwen1.5-0.5b")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    targets = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        l1, _ = loss_fn(model, tokens, targets)
        masked = targets.clone()
        masked[:, :8] = -100
        l2, _ = loss_fn(model, tokens, masked)
        l3, m3 = loss_fn(model, tokens, torch.full_like(targets, -100))
    assert torch.isfinite(l2) and not torch.allclose(l1, l2)
    assert float(m3["nll"]) == 0.0                   # no supervised position


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_train_step_smoke_bf16(arch):
    """Twin of tests/test_models.py::test_arch_train_step_smoke, in the port."""
    cfg, port_cfg = tp.reduced(arch)
    model = init_transformer(port_cfg, seed=0, device="cpu").requires_grad_(True)
    x, targets = batch(cfg, 1)
    loss, _ = loss_fn(model, tp.to_torch(x), torch.from_numpy(targets).long())
    loss.backward()
    assert torch.isfinite(loss), f"{arch}: loss not finite"
    gnorm = sum(p.grad.float().square().sum() for p in model.parameters()
                if p.grad is not None)
    assert torch.isfinite(gnorm) and gnorm > 0, f"{arch}: bad grads"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gradients_match_jax_grad_f32(arch):
    cfg, p32, model = f32_models(arch)
    x, targets = batch(cfg, 2)
    (ref_loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_loss_fn(p, jnp.asarray(x), jnp.asarray(targets), cfg),
        has_aux=True))(p32)
    _, port_cfg = tp.reduced(arch)
    ref = dict(from_reference_params(jax.tree.map(np.asarray, grads), port_cfg,
                                     device="cpu", dtype=torch.float32).named_parameters())
    model.requires_grad_(True)
    loss, _ = loss_fn(model, tp.to_torch(x), torch.from_numpy(targets).long())
    loss.backward()
    assert rel(loss.detach(), ref_loss) <= LOSS_TOL
    for name, p in model.named_parameters():
        want = ref[name].detach()
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        if float(want.norm()) == 0.0:                # a leaf the loss does not reach
            assert float(got.norm()) == 0.0, name
            continue
        err = float((got - want).norm() / want.norm())
        assert err <= GRAD_TOL, f"{arch} {name}: relative gradient error {err:.2e}"


@pytest.mark.parametrize("arch", ["rdmabox-paper-100m", "qwen2-moe-a2.7b", "hymba-1.5b"])
def test_remat_full_gives_the_same_gradients(arch):
    _, _, model = f32_models(arch)
    cfg = model.cfg
    x, targets = batch(cfg, 3)
    model.requires_grad_(True)
    grads = {}
    for remat in ("none", "full"):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, tp.to_torch(x), torch.from_numpy(targets).long(),
                          remat=remat)
        loss.backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
    assert grads["none"].keys() == grads["full"].keys()
    for name, g in grads["none"].items():
        err = float((grads["full"][name] - g).norm() / g.norm().clamp(min=1e-30))
        assert err <= REMAT_TOL, f"{arch} {name}: {err:.2e}"
