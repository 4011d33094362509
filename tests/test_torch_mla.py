"""repro_torch's MLA (deepseek-v2-lite-16b) against repro.models on the
reduced config.

The arch runs the shared parity cases of tests/torch_parity.py with every
expert routed. ``mla_train`` and the absorbed ``mla_decode`` are held to the
reference's in f32 within 1e-4, with a latent cache holding other tokens
and each sequence at another position. The port's decode from an empty
cache matches its own forward (twin of
tests/test_models.py::test_decode_matches_forward).
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
from repro.models import mla as ref_mla  # noqa: E402

from repro_torch.models.mla import MLA, LatentCache, mla_decode, mla_train  # noqa: E402

ARCHS = tp.ARCHS_BY_FILE[Path(__file__).name]
MLA_TOL = 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_keeps_every_leaf(arch):
    tp.check_conversion(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    tp.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    tp.check_prefill_decode(arch)


@pytest.fixture(scope="module")
def f32_mla():
    """(reference cfg, port cfg, reference layer-0 MLA params in f32, the
    port's MLA with the same f32 weights; kv_norm randomized)."""
    cfg, port_cfg = tp.reduced("deepseek-v2-lite-16b")
    params, _ = init_stack(jax.random.PRNGKey(9), cfg)
    params = tp.randomize(params)
    leaves = {k: np.asarray(v[0], np.float32) for k, v in params["blocks"]["mla"].items()}
    mod = MLA(port_cfg, device=torch.device("cpu")).float()
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(leaves[name]))
    return cfg, port_cfg, {k: jnp.asarray(v) for k, v in leaves.items()}, mod


@torch.no_grad()
def test_mla_train_matches_reference(f32_mla):
    cfg, port_cfg, ref_p, mod = f32_mla
    B, S = 2, 20
    x = np.random.default_rng(1).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    y_ref, kv_ref = ref_mla.mla_train(ref_p, jnp.asarray(x), cfg, jnp.asarray(pos),
                                      return_kv=True)
    y, c_kv, k_pe = mla_train(mod, torch.from_numpy(x), port_cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=MLA_TOL, atol=MLA_TOL)
    # the reference stores its cache piece in bf16
    np.testing.assert_array_equal(c_kv.bfloat16().float().numpy(),
                                  np.asarray(kv_ref["c_kv"], np.float32))
    np.testing.assert_array_equal(k_pe.bfloat16().float().numpy(),
                                  np.asarray(kv_ref["k_pe"], np.float32))


@torch.no_grad()
def test_mla_decode_matches_reference(f32_mla):
    """One absorbed decode step at positions (5, 11) over an f32 latent cache
    of 16 slots already holding other tokens' entries."""
    cfg, port_cfg, ref_p, mod = f32_mla
    B, S = 2, 16
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    c_kv = rng.normal(size=(B, S, cfg.kv_lora_rank)).astype(np.float32)
    k_pe = rng.normal(size=(B, S, cfg.qk_rope_dim)).astype(np.float32)
    cur = np.array([5, 11])
    y_ref, new_ref = ref_mla.mla_decode(
        ref_p, jnp.asarray(x), {"c_kv": jnp.asarray(c_kv), "k_pe": jnp.asarray(k_pe)}, cfg,
        jnp.asarray(cur, jnp.int32))
    cache = LatentCache(port_cfg, B, S, device=torch.device("cpu"), dtype=torch.float32)
    cache.c_kv[0] = torch.from_numpy(c_kv)
    cache.k_pe[0] = torch.from_numpy(k_pe)
    y = mla_decode(mod, torch.from_numpy(x), port_cfg, cache, 0, cache.plan_step(cur))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=MLA_TOL, atol=MLA_TOL)
    np.testing.assert_allclose(cache.c_kv[0].numpy(), np.asarray(new_ref["c_kv"]),
                               rtol=MLA_TOL, atol=MLA_TOL)
    np.testing.assert_allclose(cache.k_pe[0].numpy(), np.asarray(new_ref["k_pe"]),
                               rtol=MLA_TOL, atol=MLA_TOL)


def test_latent_cache_refuses_a_position_past_its_length():
    _, port_cfg = tp.reduced("deepseek-v2-lite-16b")
    cache = LatentCache(port_cfg, 1, 8, device=torch.device("cpu"))
    with pytest.raises(IndexError):
        cache.plan_step(np.array([8]))
    with pytest.raises(IndexError):
        cache.prompt_plan(1, 9)


def test_decode_matches_forward():
    """Twin of tests/test_models.py::test_decode_matches_forward for
    deepseek-v2-lite-16b: every expert routed, capacity factor 2.0."""
    cfg, _ = tp.reduced("deepseek-v2-lite-16b")
    err = tp.port_decode_vs_forward("deepseek-v2-lite-16b", top_k=cfg.num_experts,
                                    capacity_factor=2.0)
    assert err < tp.TOL
