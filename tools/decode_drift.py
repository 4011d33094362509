#!/usr/bin/env python3
"""Decode-vs-forward drift of the JAX reference and of the port, on the same
weights, at full width.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/decode_drift.py \\
        [--arch hymba-1.5b] [--reduced] [--device cpu] [--layers N] [--all-experts]

``--layers N`` cuts the depth to N layers at full width (deepseek-v2-lite-16b's
27 layers do not fit a 96 GiB host twice over); ``--all-experts`` routes every
token to every expert at capacity 2.0 (top_k = num_experts, as
tests/test_models.py pins a MoE arch's decode-vs-forward: top-k routing is
discontinuous, so a rounding difference can move a token to another expert
between the decode and the forward).

The reference's ``init_stack`` weights (key 0, bf16) go through numpy into
the port (``from_reference_params``). Each package
prefills the same 64-token prompt (B 1, token ids from seed 0), decodes 16
greedy steps (each feeding its own argmax), and runs one forward over its
own 80 tokens (zero-padded to whole scan chunks); its drift is max|forward − decode| / max(|forward|, 1) over
the 16 decoded positions, the measure of tests/test_models.py. The two
greedy runs feed different tokens once their argmaxes part, so the port
also decodes teacher-forced on the reference's greedy tokens: the same
sequence in both packages. The
reference runs on JAX's platform (``JAX_PLATFORMS``), the port on
``--device`` (its plain versions on the CPU). Prints one JSON line with
both drifts, per step, and the seconds each package took.

A prompt at most the window long keeps the reference's sliding-window
decode off its fault (ROADMAP.md §3), so the two decodes compute the same
function.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.configs import get_config, get_reduced, replace  # noqa: E402
from repro.models import decode_step, forward, init_cache, init_stack, prefill  # noqa: E402

from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.models import from_reference_params  # noqa: E402

PROMPT, STEPS = 64, 16


def drift(full: np.ndarray, dec: np.ndarray) -> list:
    """Per decoded position, max|full − dec| / max(|full|, 1)."""
    return [float(np.abs(full[:, i] - dec[:, i]).max() / max(np.abs(full[:, i]).max(), 1.0))
            for i in range(dec.shape[1])]


def _padded(cfg, seq: np.ndarray) -> np.ndarray:
    """``seq`` zero-padded to whole scan chunks (a causal forward: the padding
    changes no position before it)."""
    n = seq.shape[1]
    K = min(cfg.ssm_chunk, n) if cfg.mixer in ("ssm", "hybrid") else n
    out = np.zeros((seq.shape[0], -(-n // K) * K), seq.dtype)
    out[:, :n] = seq
    return out


def _splice(full, part):
    """The reference serve's splice of a prompt-length cache leaf (L, B, ...)."""
    if full.shape == part.shape:
        return part.astype(full.dtype)
    return full.at[:, :, :part.shape[2]].set(part.astype(full.dtype))


def reference(cfg, params, prompt: np.ndarray) -> dict:
    t0 = time.perf_counter()
    B, S = prompt.shape[0], PROMPT + STEPS
    last, pcache = jax.jit(lambda p, t: prefill(p, t, cfg))(params, jnp.asarray(prompt))
    cache = jax.tree.map(_splice, init_cache(cfg, B, max_len=S), pcache)
    step = jax.jit(lambda p, c, t, i: decode_step(p, c, t, i, cfg))
    toks, dec = [np.asarray(jnp.argmax(last[:, :cfg.vocab_size], -1), np.int32)], []
    for i in range(STEPS):
        logits, cache = step(params, cache, jnp.asarray(toks[-1]),
                             jnp.full((B,), PROMPT + i, jnp.int32))
        dec.append(np.asarray(logits, np.float32))
        toks.append(np.asarray(jnp.argmax(logits[:, :cfg.vocab_size], -1), np.int32))
    fed = np.stack(toks[:STEPS], 1)
    seq = np.concatenate([prompt, fed], 1)
    full = np.asarray(jax.jit(lambda p, t: forward(p, t, cfg)[0])(
        params, jnp.asarray(_padded(cfg, seq))), np.float32)[:, PROMPT:PROMPT + STEPS]
    return {"drift": drift(full, np.stack(dec, 1)), "fed": fed.tolist(),
            "seconds": time.perf_counter() - t0}


@torch.no_grad()
def port(model, prompt: np.ndarray, device: str, fed=None) -> dict:
    """Greedy, or (``fed``) teacher-forced on the given tokens."""
    t0 = time.perf_counter()
    B = prompt.shape[0]
    vocab = model.cfg.vocab_size
    cache = model.init_cache(B, PROMPT + STEPS)
    last = model.prefill(torch.from_numpy(prompt).long().to(device), cache)
    toks, dec = [last[:, :vocab].argmax(-1)], []
    for i in range(STEPS):
        if fed is not None:
            toks[-1] = torch.tensor(fed, device=device)[:, i]
        logits = model.decode_step(cache, toks[-1], np.full(B, PROMPT + i))
        dec.append(logits.float())
        toks.append(logits[:, :vocab].argmax(-1))
    seq = np.concatenate([prompt, torch.stack(toks[:STEPS], 1).cpu().numpy()], 1)
    full = model(torch.from_numpy(_padded(model.cfg, seq)).long().to(device))
    full = full[:, PROMPT:PROMPT + STEPS].float()
    return {"drift": drift(full.cpu().numpy(), torch.stack(dec, 1).cpu().numpy()),
            "seconds": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--all-experts", action="store_true",
                    help="a MoE arch routes every token to every expert (capacity 2.0)")
    args = ap.parse_args()
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        cfg = replace(cfg, num_layers=args.layers)
    if args.all_experts:
        cfg = replace(cfg, top_k=cfg.num_experts, capacity_factor=2.0)
    t0 = time.perf_counter()
    params, _ = init_stack(jax.random.PRNGKey(0), cfg)      # bf16 weights, as initialised
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)
    ref = reference(cfg, params, prompt)
    model = from_reference_params(jax.tree.map(np.asarray, params),
                                  ModelConfig(**cfg.__dict__), device=args.device)
    del params
    ours = port(model, prompt, args.device)
    same = port(model, prompt, args.device, fed=ref["fed"])
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
        "dtype": "bfloat16", "batch": 1, "prompt": PROMPT, "greedy_steps": STEPS,
        "jax_platform": jax.devices()[0].platform, "port_device": args.device,
        "max_drift": {"reference": max(ref["drift"]), "port": max(ours["drift"]),
                      "port_on_reference_tokens": max(same["drift"])},
        "mean_drift": {"reference": float(np.mean(ref["drift"])),
                       "port": float(np.mean(ours["drift"])),
                       "port_on_reference_tokens": float(np.mean(same["drift"]))},
        "reference": ref, "port": ours, "port_on_reference_tokens": same,
        "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
