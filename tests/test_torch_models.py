"""repro_torch's dense model against repro.models on the reduced qwen1.5-0.5b.

Both packages run the reference's weights: ``init_stack``'s tree goes
through numpy into ``from_reference_params``. The reference inits QKV
biases to zero and norm weights to one, which would hide a dropped bias
or norm, so those leaves are overwritten with seeded random values first.
Logits are compared as max|a − b| / max(|a|, 1) < 0.05: the tolerance
tests/test_models.py uses for bf16 weights and different contraction
orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_reduced as ref_get_reduced  # noqa: E402
from repro.models import decode_step, forward, init_cache, init_stack, prefill  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import port_only_at_defaults, shared_fields  # noqa: E402
from repro_torch.models import from_reference_params, init_transformer  # noqa: E402

ARCH = "qwen1.5-0.5b"
TOL = 0.05


def rel_err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1.0))


@pytest.fixture(scope="module")
def models():
    """(reference cfg, reference params, port model) with the same weights."""
    cfg = ref_get_reduced(ARCH)
    params, _ = init_stack(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(0)
    L, M = cfg.num_layers, cfg.d_model

    def rand(shape, mean, scale):
        return jnp.asarray(mean + scale * rng.normal(size=shape), jnp.bfloat16)

    attn = params["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = rand(attn[name].shape, 0.0, 0.5)
    for name in ("norm_mixer", "norm_ffn"):
        params["blocks"][name] = rand((L, M), 1.0, 0.2)
    params["final_norm"] = rand((M,), 1.0, 0.2)
    model = from_reference_params(jax.tree.map(np.asarray, params),
                                  get_reduced(ARCH), device="cpu")
    return cfg, params, model


def tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_copy_the_reference(arch):
    """Every arch of the reference's registry, in its order; each config
    field for field (every field the reference's ``ModelConfig`` has) and its
    derived counts equal, and the port's own fields at their defaults."""
    from repro.configs import ARCH_IDS as REF_ARCH_IDS
    assert ARCH_IDS == REF_ARCH_IDS
    for ours, theirs in ((get_config(arch), ref_get_config(arch)),
                         (get_reduced(arch), ref_get_reduced(arch))):
        assert shared_fields(ours) == dataclasses.asdict(theirs)
        assert port_only_at_defaults(ours)
        for prop in ("padded_vocab", "uses_attention", "uses_ssm", "uses_moe", "d_inner",
                     "sub_quadratic"):
            assert getattr(ours, prop) == getattr(theirs, prop), prop
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_published_deepseek_is_the_benchmarks_configuration():
    """``bench/configs/deepseek-v2-lite-16b.json``'s ``model`` is the port's
    ``PUBLISHED`` field for field; it differs from the reference's twin only
    in the published structure (the dense first layer, gates, dropless
    routing, YaRN, the norm's eps) and where it is sharded."""
    import json
    import os

    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.deepseek_v2_lite_16b import CONFIG, PUBLISHED
    path = os.path.join(os.path.dirname(__file__), "..", "bench", "configs",
                        "deepseek-v2-lite-16b.json")
    with open(path) as f:
        model = json.load(f)["model"]
    assert ModelConfig(**model) == PUBLISHED
    differ = {k for k, v in dataclasses.asdict(PUBLISHED).items()
              if v != getattr(CONFIG, k)}
    assert differ == {"d_ff", "norm_eps", "sharding_overrides", "first_dense_layers",
                      "norm_topk_prob", "moe_dropless", "yarn_factor",
                      "yarn_original_max_pos", "yarn_mscale", "yarn_mscale_all_dim"}


def test_conversion_keeps_every_leaf(models):
    cfg, params, model = models
    wq = np.asarray(params["blocks"]["attn"]["wq"][1], np.float32)
    np.testing.assert_array_equal(model.blocks[1].attn.wq.float().numpy(), wq)
    bk = np.asarray(params["blocks"]["attn"]["bk"][0], np.float32)
    np.testing.assert_array_equal(model.blocks[0].attn.bk.float().numpy(), bk)
    with pytest.raises(KeyError):
        from_reference_params({"embed": np.asarray(params["embed"])},
                              get_reduced(ARCH), device="cpu")


def test_forward_matches_reference(models):
    cfg, params, model = models
    toks = tokens(1, 2, 24, cfg.vocab_size)
    ref, _ = jax.jit(lambda p, t: forward(p, t, cfg))(params, jnp.asarray(toks))
    ours = model(torch.from_numpy(toks).long())
    assert ours.shape == ref.shape
    assert rel_err(ref, ours) < TOL


def test_prefill_and_paged_decode_match_reference(models):
    """Prefill 16 tokens, then 8 teacher-forced decode steps over pages of 4
    tokens in blocks of 2 pages: the port's paged pool vs the reference's
    dense cache."""
    cfg, params, model = models
    B, S, steps = 2, 16, 8
    toks = tokens(2, B, S + steps, cfg.vocab_size)

    ref_last, pcache = jax.jit(lambda p, t: prefill(p, t, cfg))(
        params, jnp.asarray(toks[:, :S]))
    cache = jax.tree.map(
        lambda full, part: full.at[:, :, :part.shape[2]].set(part.astype(full.dtype)),
        init_cache(cfg, B, max_len=S + steps), pcache)
    step = jax.jit(lambda p, c, t, i: decode_step(p, c, t, i, cfg))

    pool = model.init_cache(B, S + steps, page_tokens=4, pages_per_block=2)
    last = model.prefill(torch.from_numpy(toks[:, :S]).long(), pool)
    assert rel_err(ref_last, last) < TOL
    for i in range(steps):
        ref_logits, cache = step(params, cache, jnp.asarray(toks[:, S + i]),
                                 jnp.full((B,), S + i, jnp.int32))
        ours = model.decode_step(pool, torch.from_numpy(toks[:, S + i]).long(),
                                 np.full(B, S + i))
        assert rel_err(ref_logits, ours) < TOL, f"decode step {i}"


def test_greedy_ids_match_reference(models):
    """Greedy continuation for 4 steps equals the reference's wherever the
    reference's top-2 margin is wider than the tolerance (a near-tie may
    legitimately flip under bf16, and then the sequences part)."""
    cfg, params, model = models
    B, S, steps = 2, 12, 4
    toks = tokens(3, B, S, cfg.vocab_size)
    ref_logits, pcache = jax.jit(lambda p, t: prefill(p, t, cfg))(
        params, jnp.asarray(toks))
    cache = jax.tree.map(
        lambda full, part: full.at[:, :, :part.shape[2]].set(part.astype(full.dtype)),
        init_cache(cfg, B, max_len=S + steps), pcache)
    step = jax.jit(lambda p, c, t, i: decode_step(p, c, t, i, cfg))
    pool = model.init_cache(B, S + steps, page_tokens=4)
    ours = model.prefill(torch.from_numpy(toks).long(), pool)
    live = np.ones(B, bool)
    compared = 0
    for i in range(steps):
        ref_np = np.asarray(ref_logits[:, : cfg.vocab_size], np.float32)
        top2 = np.sort(ref_np, axis=-1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]) / np.maximum(np.abs(ref_np).max(-1), 1.0)
        live &= margin > TOL
        ref_tok = ref_np.argmax(-1)
        our_tok = ours[:, : cfg.vocab_size].argmax(-1).numpy()
        np.testing.assert_array_equal(our_tok[live], ref_tok[live])
        compared += int(live.sum())
        ref_logits, cache = step(params, cache, jnp.asarray(ref_tok, jnp.int32),
                                 jnp.full((B,), S + i, jnp.int32))
        ours = model.decode_step(pool, torch.from_numpy(our_tok), np.full(B, S + i))
    assert compared > 0


def test_decode_matches_forward():
    """Token-by-token paged decode from an empty pool reproduces the parallel
    forward (twin of tests/test_models.py::test_decode_matches_forward)."""
    cfg = get_reduced(ARCH)
    model = init_transformer(cfg, seed=1, device="cpu")
    B, S = 1, 24
    toks = torch.from_numpy(tokens(4, B, S, cfg.vocab_size)).long()
    full = model(toks)
    pool = model.init_cache(B, S, page_tokens=8)
    dec = torch.stack([model.decode_step(pool, toks[:, t], np.full(B, t))
                       for t in range(S)], dim=1)
    assert rel_err(full, dec) < TOL


def test_prefill_then_decode_continues():
    """Twin of tests/test_models.py::test_prefill_then_decode_continues."""
    cfg = get_reduced(ARCH)
    model = init_transformer(cfg, seed=0, device="cpu")
    B, S = 2, 32
    toks = torch.from_numpy(tokens(5, B, S + 1, cfg.vocab_size)).long()
    pool = model.init_cache(B, S + 8)
    model.prefill(toks[:, :S], pool)
    logits = model.decode_step(pool, toks[:, S], np.full(B, S))
    full = model(toks)
    assert rel_err(full[:, S], logits) < TOL


def test_entry_points_need_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_transformer(get_reduced(ARCH))
