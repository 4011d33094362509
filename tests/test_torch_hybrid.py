"""repro_torch's hybrid arch (hymba-1.5b: attention with a sliding window in
parallel with the Mamba-2 SSM) against repro.models on the reduced config.

The arch runs the shared parity cases of tests/torch_parity.py (prompts
inside the window). The decode cache is a ring of the last ``window``
tokens' K/V plus the SSM state. The port places prompt token p at ring slot
p % window; the reference's prefill keeps the last ``window`` tokens at
slots 0..window−1 while its decode assumes p % window, so the two agree
when the prompt is at most a window or a multiple of it, and the
reference's decode evicts the wrong token otherwise. So the port is held
to its own forward at a prompt of 96 with a window of 64, and to the
reference at a prompt of exactly one window.

Run as a script, the file measures the fault in both packages, on the same
weights, at the reduced config cut to window 8 and scan chunk 4 (prompts
8, 12 and 16, then 4 decode steps, against one forward):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_hybrid.py
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

import torch_parity as tp  # noqa: E402
from repro.models import forward  # noqa: E402

from repro_torch.models import HybridCache, RingKVCache, SSMCache  # noqa: E402

ARCHS = tp.ARCHS_BY_FILE[Path(__file__).name]
ARCH = "hymba-1.5b"


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_keeps_every_leaf(arch):
    tp.check_conversion(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    tp.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    tp.check_prefill_decode(arch)


def test_decode_matches_forward():
    """Twin of tests/test_models.py::test_decode_matches_forward for hymba."""
    assert tp.port_decode_vs_forward(ARCH) < tp.TOL


def test_hybrid_cache_holds_a_ring_and_the_ssm_state():
    cfg, _, model = tp.models(ARCH)
    cache = model.init_cache(2, 200)
    assert isinstance(cache, HybridCache)
    assert isinstance(cache.kv, RingKVCache) and isinstance(cache.ssm, SSMCache)
    # min(max_len, window) slots a sequence, as the reference's init_kv_cache
    assert cache.kv.bufs[0].shape == (cfg.num_layers, 2, cfg.window, cfg.num_kv_heads,
                                      cfg.head_dim)
    assert model.init_cache(2, 40).kv.length == 40


def test_ring_places_prompt_token_p_at_slot_p_mod_window():
    cfg, _, model = tp.models(ARCH)
    ring = model.init_cache(1, 200).kv
    pos, slots = ring.prompt_plan(1, 96)
    assert pos.tolist() == list(range(32, 96))
    assert slots.tolist() == [p % 64 for p in range(32, 96)]
    plan = ring.plan_step(np.array([96]))
    assert plan.slot.tolist() == [32]          # evicts token 32 = 96 − window
    assert plan.valid.all()
    early = ring.plan_step(np.array([5]))      # before the ring fills
    assert early.valid[0].nonzero().flatten().tolist() == list(range(6))


@torch.no_grad()
def test_ring_decode_matches_own_forward_past_the_window():
    """Prompt 96 (window 64: 96 % 64 ≠ 0, where the reference's splice
    misplaces the ring), 32 decode steps, against one forward over 128."""
    cfg, _, model = tp.models(ARCH)
    prompt, steps = 96, 32
    x = tp.inputs(cfg, 6, 2, prompt + steps)
    _, outs, _ = tp.port_prefill_decode(model, x, prompt)
    full = model(tp.to_torch(x))[:, prompt:]
    assert tp.rel_err(full, torch.stack(outs, dim=1)) < tp.TOL


def test_ring_decode_matches_reference_at_a_whole_window():
    """Prompt of exactly one window (64), 8 decode steps that wrap the ring:
    the reference's placement is right here, and the port matches it."""
    cfg, params, model = tp.models(ARCH)
    prompt, steps = cfg.window, 8
    x = tp.inputs(cfg, 7, 2, prompt + steps)
    ref_last, ref_steps = tp.reference_prefill_decode(cfg, params, x, prompt)
    last, outs, _ = tp.port_prefill_decode(model, x, prompt)
    assert tp.rel_err(ref_last, last) < tp.TOL
    for i, (r, o) in enumerate(zip(ref_steps, outs)):
        assert tp.rel_err(r, o) < tp.TOL, f"decode step {i}"


def ring_fault(prompts=(8, 12, 16), steps: int = 4, seeds=(0, 1, 2)) -> dict:
    """Both packages' decode-vs-forward error at the reduced hymba cut to
    window 8 and scan chunk 4: prompt → [(reference, port) a seed]."""
    out = {}
    for P in prompts:
        rows = []
        for seed in seeds:
            tp.models.cache_clear()
            cfg, params, model = tp.models(ARCH, key=seed, window=8, ssm_chunk=4)
            x = tp.inputs(cfg, 10 + seed, 2, P + steps)
            full = np.asarray(jax.jit(lambda p, t: forward(p, t, cfg)[0])(
                params, jnp.asarray(x)), np.float32)[:, P:]
            _, ref_steps = tp.reference_prefill_decode(cfg, params, x, P)
            _, outs, _ = tp.port_prefill_decode(model, x, P)
            with torch.no_grad():
                own = model(tp.to_torch(x))[:, P:]
            rows.append((tp.rel_err(full, np.stack(ref_steps, axis=1)),
                         tp.rel_err(own, torch.stack(outs, dim=1))))
        out[P] = rows
    return out


if __name__ == "__main__":
    for P, rows in ring_fault().items():
        print(json.dumps({"prompt": P, "window": 8, "decode_steps": 4,
                          "reference_rel_err": [r for r, _ in rows],
                          "port_rel_err": [p for _, p in rows]}))
