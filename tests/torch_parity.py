"""Shared parity harness of the port's per-arch tests (tests/test_torch_archs_*.py,
test_torch_moe.py, test_torch_mla.py, test_torch_hybrid.py).

Both packages run the reference's weights: ``init_stack``'s tree goes
through numpy into ``from_reference_params``. The reference inits biases
and some SSM leaves to zero and norms (MLA's ``kv_norm`` too), ``A_log``
and ``D`` to one, which would hide a dropped or misplaced term, so those
leaves are overwritten with seeded random values first. Logits are
compared as max|a − b| / max(|a|, 1) < 0.05: the tolerance
tests/test_models.py uses for bf16 weights and different contraction
orders. Inputs are token ids, or standard-normal embeddings for the archs
with a stubbed frontend, made with numpy and handed to both packages.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.configs import replace as ref_replace
from repro.models import decode_step, forward, init_cache, init_stack, prefill

from repro_torch.configs import ModelConfig
from repro_torch.models import from_reference_params, init_transformer

TOL = 0.05

# which test file holds which archs' parity cases (their union is ARCH_IDS)
ARCHS_BY_FILE = {
    "test_torch_archs_dense.py": ["command-r-35b", "qwen1.5-32b", "qwen2.5-32b",
                                  "qwen1.5-0.5b", "rdmabox-paper-100m", "mamba2-780m"],
    "test_torch_archs_frontend.py": ["musicgen-large", "llava-next-34b"],
    "test_torch_moe.py": ["qwen2-moe-a2.7b"],
    "test_torch_mla.py": ["deepseek-v2-lite-16b"],
    "test_torch_hybrid.py": ["hymba-1.5b"],
}

# leaf name → (mean, scale) of the seeded values that replace its constant init
RANDOMIZED = {"bq": (0.0, 0.5), "bk": (0.0, 0.5), "bv": (0.0, 0.5),
              "norm_mixer": (1.0, 0.2), "norm_ffn": (1.0, 0.2), "final_norm": (1.0, 0.2),
              "kv_norm": (1.0, 0.2), "A_log": (0.0, 0.5), "D": (1.0, 0.5),
              "dt_bias": (-1.0, 0.5), "conv_b": (0.0, 0.3), "norm_w": (1.0, 0.2)}


def rel_err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1.0))


def reduced(arch: str, **overrides):
    """(reference config, the port's equal copy) of ``arch``'s reduced config."""
    cfg = ref_replace(ref_get_reduced(arch), **overrides)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def randomize(params: dict, seed: int = 0) -> dict:
    """A copy of ``params`` with every leaf named in RANDOMIZED redrawn."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in RANDOMIZED:
                mean, scale = RANDOMIZED[key]
                out[key] = jnp.asarray(mean + scale * rng.normal(size=val.shape), val.dtype)
            else:
                out[key] = val
        return out
    return walk(params)


@functools.cache
def models(arch: str, key: int = 3, **overrides):
    """(reference cfg, reference params, port model on the CPU), same weights."""
    cfg, port_cfg = reduced(arch, **overrides)
    params, _ = init_stack(jax.random.PRNGKey(key), cfg)
    params = randomize(params)
    model = from_reference_params(jax.tree.map(np.asarray, params), port_cfg, device="cpu")
    return cfg, params, model


def inputs(cfg, seed: int, B: int, S: int) -> np.ndarray:
    """Token ids (B, S) int32, or embeddings (B, S, d_model) f32 for a frontend arch."""
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def to_torch(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.long() if x.dtype == np.int32 else t


def splice_leaf(full, part):
    """The reference serve's splice of a prompt-length cache leaf into the
    decode cache (src/repro/launch/serve.py): leaves are (L, B, ...)."""
    if full.shape == part.shape:
        return part.astype(full.dtype)
    if full.ndim >= 3 and part.ndim == full.ndim and part.shape[2] <= full.shape[2]:
        return full.at[:, :, :part.shape[2]].set(part.astype(full.dtype))
    return part.astype(full.dtype)


def reference_prefill_decode(cfg, params, x: np.ndarray, prompt: int):
    """The reference's prefill of ``x[:, :prompt]``, serve's splice, then one
    ``decode_step`` a remaining position; (last prefill logits, [step logits])."""
    B, S = x.shape[:2]
    last, pcache = jax.jit(lambda p, t: prefill(p, t, cfg))(params, jnp.asarray(x[:, :prompt]))
    cache = jax.tree.map(splice_leaf, init_cache(cfg, B, max_len=S), pcache)
    step = jax.jit(lambda p, c, t, i: decode_step(p, c, t, i, cfg))
    outs = []
    for i in range(prompt, S):
        logits, cache = step(params, cache, jnp.asarray(x[:, i]),
                             jnp.full((B,), i, jnp.int32))
        outs.append(np.asarray(logits, np.float32))
    return np.asarray(last, np.float32), outs


@torch.no_grad()
def port_prefill_decode(model, x: np.ndarray, prompt: int, **cache_kw):
    """The port's prefill into its decode cache, then one step a remaining position."""
    B, S = x.shape[:2]
    xt = to_torch(x)
    cache = model.init_cache(B, S, **cache_kw)
    last = model.prefill(xt[:, :prompt], cache)
    outs = [model.decode_step(cache, xt[:, i], np.full(B, i)) for i in range(prompt, S)]
    return last, outs, cache


# ---------------------------------------------------------------------------
# the cases every arch runs
# ---------------------------------------------------------------------------

def check_conversion(arch: str) -> None:
    """Every port parameter holds its reference leaf exactly; a missing or a
    left-over leaf raises."""
    cfg, params, model = models(arch)
    flat = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                flat[f"{prefix}{key}"] = np.asarray(val, np.float32)
    walk(params, "")
    seen = set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            key = ".".join(["blocks", *parts[2:]])
            want = flat[key][int(parts[1])]
        else:
            key, want = name, flat[name]
        np.testing.assert_array_equal(p.float().numpy(), want, err_msg=name)
        seen.add(key)
    assert seen == set(flat)
    np_params = jax.tree.map(np.asarray, params)
    _, port_cfg = reduced(arch)
    missing = dict(np_params, blocks={k: v for k, v in np_params["blocks"].items()
                                      if k != "norm_ffn"})
    with pytest.raises(KeyError, match="no leaf for"):
        from_reference_params(missing, port_cfg, device="cpu")
    extra = dict(np_params, stray=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="no port parameter"):
        from_reference_params(extra, port_cfg, device="cpu")


@torch.no_grad()
def check_forward(arch: str, S: int = 24) -> None:
    cfg, params, model = models(arch, **moe_pin(arch))
    x = inputs(cfg, 1, 2, S)
    ref, _ = jax.jit(lambda p, t: forward(p, t, cfg))(params, jnp.asarray(x))
    ours = model(to_torch(x))
    assert ours.shape == ref.shape
    err = rel_err(ref, ours)
    assert err < TOL, f"{arch}: forward rel err {err:.4f}"


def check_prefill_decode(arch: str, prompt: int = 16, steps: int = 8) -> None:
    """Prefill, then ``steps`` decode steps (teacher-forced), against the
    reference's prefill, splice and ``decode_step`` (the twin of
    tests/test_models.py::test_arch_decode_smoke, held to the reference's
    logits). Pages of 4 tokens in blocks of 2 for the paged archs."""
    cfg, params, model = models(arch, **moe_pin(arch))
    x = inputs(cfg, 2, 2, prompt + steps)
    ref_last, ref_steps = reference_prefill_decode(cfg, params, x, prompt)
    last, outs, _ = port_prefill_decode(model, x, prompt, page_tokens=4, pages_per_block=2)
    assert rel_err(ref_last, last) < TOL, f"{arch}: prefill"
    for i, (r, o) in enumerate(zip(ref_steps, outs)):
        assert o.shape == r.shape
        assert torch.isfinite(o).all()
        assert rel_err(r, o) < TOL, f"{arch}: decode step {i}"


def moe_pin(arch: str) -> dict:
    """top_k = num_experts and capacity factor 2.0 for a MoE arch, as
    tests/test_models.py pins them: top-k routing is discontinuous, and
    bf16 differences between two packages can flip a boundary expert."""
    cfg = ref_get_reduced(arch)
    return {"top_k": cfg.num_experts, "capacity_factor": 2.0} if cfg.num_experts else {}


@torch.no_grad()
def port_decode_vs_forward(arch: str, S: int = 24, seed: int = 1, **overrides) -> float:
    """The port's token-by-token decode from an empty cache against its own
    forward (twin of tests/test_models.py::test_decode_matches_forward)."""
    cfg, port_cfg = reduced(arch, **overrides)
    model = init_transformer(port_cfg, seed=seed, device="cpu")
    x = to_torch(inputs(cfg, 4, 1, S))
    full = model(x)
    cache = model.init_cache(1, S)
    dec = torch.stack([model.decode_step(cache, x[:, t], np.full(1, t)) for t in range(S)],
                      dim=1)
    return rel_err(full, dec)
