"""repro_torch's SSM stack against repro.models on the reduced mamba2-780m.

Both packages run the reference's weights: ``init_stack``'s tree goes
through numpy into ``from_reference_params``. The reference inits
``A_log`` and ``D`` to one, ``dt_bias`` and ``conv_b`` to zero and the
norms to one, which would hide a dropped or misplaced term, so those
leaves are overwritten with seeded random values first. Logits are
compared as max|a − b| / max(|a|, 1) < 0.05: the tolerance
tests/test_models.py uses for bf16 weights and different contraction
orders. The reduced config has chunk 32, so S = 64 runs two chunks and
carries the state across a chunk boundary.

Run as a script, the file measures how far decode drifts from the forward
in both packages at any width and depth, in bf16 and in f32, on the same
weights and tokens (a measurement for the record, not a test):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ssm.py --full \
        [--device cuda]
"""

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from repro.configs import get_reduced as ref_get_reduced  # noqa: E402
from repro.models import decode_step, forward, init_cache, init_stack, prefill  # noqa: E402

from repro_torch.configs import ModelConfig, get_reduced  # noqa: E402
from repro_torch.models import SSMCache, from_reference_params, init_transformer  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

ARCH = "mamba2-780m"
TOL = 0.05
SSM_LEAVES = ("w_z", "w_xbc", "w_dt", "conv_w", "conv_b", "A_log", "D", "dt_bias",
              "norm_w", "w_out")


def rel_err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1.0))


def tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """(reference cfg, reference params, port model) with the same weights."""
    cfg = ref_get_reduced(ARCH)
    params, _ = init_stack(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(0)
    L, M = cfg.num_layers, cfg.d_model

    def rand(shape, mean, scale):
        return jnp.asarray(mean + scale * rng.normal(size=shape), jnp.bfloat16)

    ssm = params["blocks"]["ssm"]
    for name, mean, scale in (("A_log", 0.0, 0.5), ("D", 1.0, 0.5),
                              ("dt_bias", -1.0, 0.5), ("conv_b", 0.0, 0.3),
                              ("norm_w", 1.0, 0.2)):
        ssm[name] = rand(ssm[name].shape, mean, scale)
    params["blocks"]["norm_mixer"] = rand((L, M), 1.0, 0.2)
    params["final_norm"] = rand((M,), 1.0, 0.2)
    model = from_reference_params(jax.tree.map(np.asarray, params),
                                  get_reduced(ARCH), device="cpu")
    return cfg, params, model


def test_conversion_carries_every_ssm_leaf(models):
    cfg, params, model = models
    assert model.blocks[0].attn is None and model.blocks[0].mlp is None
    ours = {n.split(".")[-1] for n, _ in model.blocks[0].ssm.named_parameters()}
    assert ours == set(params["blocks"]["ssm"]) == set(SSM_LEAVES)
    for layer in range(cfg.num_layers):
        for name in SSM_LEAVES:
            ref = np.asarray(params["blocks"]["ssm"][name][layer], np.float32)
            np.testing.assert_array_equal(
                getattr(model.blocks[layer].ssm, name).float().numpy(), ref,
                err_msg=f"blocks.{layer}.ssm.{name}")
    with pytest.raises(KeyError):      # a dropped leaf is refused, not ignored
        tree = jax.tree.map(np.asarray, params)
        del tree["blocks"]["ssm"]["D"]
        from_reference_params(tree, get_reduced(ARCH), device="cpu")


def test_forward_matches_reference(models):
    cfg, params, model = models
    toks = tokens(1, 2, 64, cfg.vocab_size)
    ref, _ = jax.jit(lambda p, t: forward(p, t, cfg))(params, jnp.asarray(toks))
    ours = model(torch.from_numpy(toks).long())
    assert ours.shape == ref.shape
    assert rel_err(ref, ours) < TOL


def test_prefill_and_decode_match_reference(models):
    """Prefill 64 tokens (two chunks), then 8 teacher-forced decode steps:
    the port's SSMCache against the reference's stacked SSM cache."""
    cfg, params, model = models
    B, S, steps = 2, 64, 8
    toks = tokens(2, B, S + steps, cfg.vocab_size)

    ref_last, pcache = jax.jit(lambda p, t: prefill(p, t, cfg))(
        params, jnp.asarray(toks[:, :S]))
    full = init_cache(cfg, B, max_len=S + steps)
    cache = jax.tree.map(lambda f, part: part.astype(f.dtype), full, pcache)
    step = jax.jit(lambda p, c, t, i: decode_step(p, c, t, i, cfg))

    ours_cache = model.init_cache(B, S + steps)
    assert isinstance(ours_cache, SSMCache)
    last = model.prefill(torch.from_numpy(toks[:, :S]).long(), ours_cache)
    assert rel_err(ref_last, last) < TOL
    for leaf in ("conv", "h"):
        ref_leaf = cache["ssm"][leaf]
        assert tuple(ref_leaf.shape) == tuple(getattr(ours_cache, leaf).shape)
        assert rel_err(ref_leaf, getattr(ours_cache, leaf)) < TOL, leaf
    for i in range(steps):
        ref_logits, cache = step(params, cache, jnp.asarray(toks[:, S + i]),
                                 jnp.full((B,), S + i, jnp.int32))
        ours = model.decode_step(ours_cache, torch.from_numpy(toks[:, S + i]).long(),
                                 np.full(B, S + i))
        assert rel_err(ref_logits, ours) < TOL, f"decode step {i}"


def test_decode_matches_forward():
    """Token-by-token SSM decode from a zero state reproduces the parallel
    forward (twin of tests/test_models.py::test_decode_matches_forward)."""
    cfg = get_reduced(ARCH)
    model = init_transformer(cfg, seed=1, device="cpu")
    B, S = 1, 24
    toks = torch.from_numpy(tokens(4, B, S, cfg.vocab_size)).long()
    full = model(toks)
    cache = model.init_cache(B, S)
    dec = torch.stack([model.decode_step(cache, toks[:, t], np.full(B, t))
                       for t in range(S)], dim=1)
    assert rel_err(full, dec) < TOL


def test_prefill_then_decode_continues():
    """Twin of tests/test_models.py::test_prefill_then_decode_continues:
    prefill two chunks, decode the next token, against one forward. The
    forward runs over three whole chunks (the SSM takes no ragged length);
    causality makes its logits at position S depend on tokens ≤ S only."""
    cfg = get_reduced(ARCH)
    model = init_transformer(cfg, seed=0, device="cpu")
    B, S = 2, 2 * cfg.ssm_chunk
    toks = torch.from_numpy(tokens(5, B, S + cfg.ssm_chunk, cfg.vocab_size)).long()
    cache = model.init_cache(B, S + 1)
    model.prefill(toks[:, :S], cache)
    logits = model.decode_step(cache, toks[:, S], np.full(B, S))
    full = model(toks)
    assert rel_err(full[:, S], logits) < TOL


def test_forward_refuses_a_length_off_the_chunk():
    cfg = get_reduced(ARCH)
    model = init_transformer(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="multiple of ssm_chunk"):
        model(torch.zeros((1, cfg.ssm_chunk + 8), dtype=torch.long))


def test_init_weights_ssm_rule():
    """The reference's init_ssm values: A_log = D = norm_w = 1, dt_bias =
    conv_b = 0, conv_w ~ N(0, 0.5²)."""
    cfg = get_reduced(ARCH)
    model = init_transformer(cfg, seed=7, device="cpu")
    for blk in model.blocks:
        p = blk.ssm
        assert (p.A_log == 1).all() and (p.D == 1).all() and (p.norm_w == 1).all()
        assert (p.conv_b == 0).all() and (p.dt_bias == 0).all()
        std = p.conv_w.float().std().item()
        assert abs(std - 0.5) < 0.05, std
        assert abs(p.w_xbc.float().std().item() - cfg.d_model ** -0.5) < 0.01


def test_transformer_refuses_unported_archs():
    """Every mixer and attention kind of the registry has a block now (the
    hybrid, MoE and frontend variants of this config build); a kind the
    reference has no block for is refused."""
    from repro_torch.configs import replace
    cfg = get_reduced(ARCH)
    for ok in (replace(cfg, mixer="hybrid", attention="gqa", num_heads=4, num_kv_heads=2,
                       head_dim=32, window=16),
               replace(cfg, num_experts=4, top_k=2, moe_d_ff=32),
               replace(cfg, frontend="audio")):
        Transformer(ok, device="cpu")
    for bad in (replace(cfg, mixer="retnet"), replace(cfg, attention="linear")):
        with pytest.raises(ValueError, match="no block for mixer"):
            Transformer(bad, device="cpu")


# ---------------------------------------------------------------------------
# decode-vs-forward drift, both packages, same weights and tokens
# ---------------------------------------------------------------------------

def decode_drift(cfg, params, toks: np.ndarray, prompt: int, dtype: str,
                 device: str = "cpu") -> dict:
    """Per decode step, max|forward − decode| / max(|forward|, 1) over the
    batch and vocab, for the reference and for the port on the same weights
    cast to ``dtype``: prefill ``prompt`` tokens, decode the rest of ``toks``
    teacher-forced, and one forward over ``toks`` zero-padded to whole
    chunks (causal, so the padding changes no compared position). Also the
    two packages' forwards against each other at the same positions."""
    B, S = toks.shape
    steps = S - prompt
    K = min(cfg.ssm_chunk, S)
    padded = np.zeros((B, -(-S // K) * K), np.int32)
    padded[:, :S] = toks
    p = jax.tree.map(lambda a: a.astype(dtype), params)
    _, pc = jax.jit(lambda p, t: prefill(p, t, cfg))(p, jnp.asarray(toks[:, :prompt]))
    cache = jax.tree.map(lambda f, part: part.astype(f.dtype),
                         init_cache(cfg, B, max_len=S), pc)
    step = jax.jit(lambda p, c, t, i: decode_step(p, c, t, i, cfg))
    ref_dec = []
    for i in range(steps):
        logits, cache = step(p, cache, jnp.asarray(toks[:, prompt + i]),
                             jnp.full((B,), prompt + i, jnp.int32))
        ref_dec.append(np.asarray(logits, np.float32))
    ref_full = np.asarray(jax.jit(lambda p, t: forward(p, t, cfg)[0])(
        p, jnp.asarray(padded)), np.float32)[:, prompt:S]

    with torch.no_grad():
        model = from_reference_params(jax.tree.map(np.asarray, params),
                                      ModelConfig(**dataclasses.asdict(cfg)), device=device)
        model.to(getattr(torch, dtype))
        t = torch.from_numpy(toks).long().to(device)
        ours_cache = model.init_cache(B, S)
        model.prefill(t[:, :prompt], ours_cache)
        dec = torch.stack([model.decode_step(ours_cache, t[:, prompt + i],
                                             np.full(B, prompt + i))
                           for i in range(steps)], dim=1).float().cpu().numpy()
        full = model(torch.from_numpy(padded).long().to(device))[:, prompt:S]
        full = full.float().cpu().numpy()

    def per_step(a, b):
        return [rel_err(a[:, i], b[:, i]) for i in range(steps)]
    return {"reference": per_step(ref_full, np.stack(ref_dec, axis=1)),
            "port": per_step(full, dec),
            "port_vs_reference_forward": per_step(ref_full, full)}


def test_decode_drift_is_rounding_not_recurrence(models):
    """Decode follows the forward to f32 rounding in both packages: the
    bf16 drift is bf16's, and in f32 it all but vanishes. At full width
    (48 layers) the random-weight model amplifies bf16 rounding past the
    0.05 bound in both packages alike; run this file as a script for that."""
    cfg, params, _ = models
    toks = tokens(6, 2, 2 * cfg.ssm_chunk + 8, cfg.vocab_size)
    bf16 = decode_drift(cfg, params, toks, 2 * cfg.ssm_chunk, "bfloat16")
    f32 = decode_drift(cfg, params, toks, 2 * cfg.ssm_chunk, "float32")
    assert max(bf16["reference"]) < TOL and max(bf16["port"]) < TOL
    assert max(f32["reference"]) < 1e-4 and max(f32["port"]) < 1e-4


def _main() -> None:
    ap = argparse.ArgumentParser(description="decode-vs-forward drift, both packages")
    ap.add_argument("--full", action="store_true", help="full width (default: reduced)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args()
    from repro.configs import get_config as ref_get_config
    from repro.configs import replace
    cfg = ref_get_config(ARCH) if args.full else ref_get_reduced(ARCH)
    if args.layers:
        cfg = replace(cfg, num_layers=args.layers)
    params, _ = init_stack(jax.random.PRNGKey(0), cfg)
    batch, prompt, steps = 1, 512, 16       # two chunks of 256 at full width
    toks = tokens(0, batch, prompt + steps, cfg.vocab_size)
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        drift = decode_drift(cfg, params, toks, prompt, dtype, args.device)
        print(json.dumps({"arch": cfg.name, "layers": cfg.num_layers,
                          "d_model": cfg.d_model, "batch": batch,
                          "prompt": prompt, "steps": steps, "dtype": dtype,
                          "jax_platform": jax.devices()[0].platform,
                          "port_device": args.device,
                          "max": {k: max(v) for k, v in drift.items()}, **drift,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    _main()
