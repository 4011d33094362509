#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile every ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernels vs plain: each CUDA kernel against its plain PyTorch version on the
   card, at the reference suite's shapes and at the serving shapes;
4. serve: ``repro_torch.launch.serve.main`` at full width (qwen1.5-0.5b, batch 4,
   prompt 64, 32 decode steps) with every kernel's launch count reset just
   before and read just after; the decode logits against one forward pass over
   prompt + generated tokens;
5. profile: device time by kernel over 8 decode steps (torch.profiler);
6. kernels: each kernel's time at the serving shapes (CUDA-graph replay, so no
   host gaps), its plain version's, the bound of the card, and a library call's.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and the
script exits non-zero; without a CUDA device it fails before printing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ARCH, BATCH, PROMPT, GEN, PAGE_TOKENS = "qwen1.5-0.5b", 4, 64, 32, 16
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
DECODE_VS_FORWARD_TOL = 0.05      # tests/test_models.py's bf16 tolerance
FLASH_SHAPES = [   # Sq, Skv, H, Kh, D, causal, window (tests/test_kernels.py)
    (128, 128, 4, 2, 32, True, None),
    (128, 128, 4, 4, 64, False, None),
    (256, 256, 8, 2, 32, True, 96),
    (64, 192, 2, 2, 32, True, None),
    (64, 64, 2, 1, 128, True, None),
]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def max_err(out: torch.Tensor, ref: torch.Tensor, tol: float, what: str) -> float:
    a, b = out.float(), ref.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite output")
    if not torch.allclose(a, b, atol=tol, rtol=tol):
        raise AssertionError(f"{what}: max |err| {(a - b).abs().max().item():.3e} "
                             f"over tolerance {tol}")
    return (a - b).abs().max().item()


def device_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events (no host gaps between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def random_table(rng: np.random.Generator, B: int, Pmax: int, P: int, T: int,
                 contiguous: bool):
    """The reference suite's page tables (trailing -1 padding) and lengths."""
    table = -np.ones((B, Pmax), np.int32)
    for b in range(B):
        n = rng.integers(1, Pmax + 1)
        if contiguous:
            start = rng.integers(0, P - n)
            table[b, :n] = np.arange(start, start + n)
        else:
            table[b, :n] = rng.choice(P, size=n, replace=False)
    lengths = ((table >= 0).sum(1) * T - rng.integers(0, T, B)).astype(np.int32)
    return table, torch.from_numpy(lengths)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "name": torch.cuda.get_device_name(0)})
    return smi.splitlines()[0]


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {}
    for name, so in libs.items():
        log = so.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = {
            "used": [ln.split(":", 1)[1].strip() for ln in lines if "Used" in ln],
            "spill_free": all("0 bytes spill stores, 0 bytes spill loads" in ln
                              for ln in lines if "spill" in ln)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "ptxas": ptxas})


def phase_compare(dev: torch.device) -> dict:
    """Each kernel against its plain version; returns the serving-shape errors."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    report = {"flash": [], "paged": []}
    main_err = {}
    cfg = get_config(ARCH)
    serving = (BATCH, PROMPT, PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
               True, None)
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[dtype]
        for B, Sq, Skv, H, Kh, D, causal, window in [(2, *s) for s in FLASH_SHAPES] + [
                serving]:
            q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, Skv, Kh, D, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, Skv, Kh, D, generator=gen, device=dev).to(dtype)
            out = fa.flash_attention_op(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max_err(out, attention_ref(q, k, v, causal=causal, window=window),
                          tol, f"flash {dtype} {(B, Sq, Skv, H, Kh, D, causal, window)}")
            report["flash"].append({"shape": [B, Sq, Skv, H, Kh, D], "causal": causal,
                                    "window": window, "dtype": str(dtype),
                                    "max_abs_err": err})
        main_err[("flash", dtype)] = err          # the serving shape comes last
    for dtype in (torch.float32, torch.bfloat16):
        tol = PAGED_TOL[dtype]
        B, H, Kh, D, T, P, Pmax = 3, 8, 4, 32, 8, 40, 6
        for R in (1, 2, 4):
            for contig in (True, False):
                q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
                kv = torch.randn(P, T, 2, Kh, D, generator=gen, device=dev).to(dtype)
                table, lengths = random_table(rng, B, Pmax, P, T, contig)
                lengths = lengths.to(dev)
                out = pa.paged_attention(q, kv, table, lengths, pages_per_block=R)
                torch.cuda.synchronize()
                plan = pa.upload_plan(table, R, dev)
                what = f"paged {dtype} R={R} contiguous={contig}"
                err = max_err(out, pa.paged_attention_plain(
                    q, kv, *plan, lengths, pages_per_block=R), tol, what)
                max_err(out, paged_attention_ref(q, kv, torch.from_numpy(table).to(dev),
                                                 lengths), tol, what + " vs oracle")
                report["paged"].append({"R": R, "contiguous": contig,
                                        "dtype": str(dtype), "max_abs_err": err})
        q, kv, lengths, plan = paged_inputs(dev, gen, dtype)
        out = pa.paged_attention(q, kv, None, lengths, pages_per_block=4, plan=plan)
        torch.cuda.synchronize()
        main_err[("paged", dtype)] = max_err(
            out, pa.paged_attention_plain(q, kv, *plan, lengths, pages_per_block=4),
            tol, f"paged {dtype} serving shape")
    emit({"phase": "kernels_vs_plain", **report,
          "serving_shape_max_abs_err": {f"{k}/{d}": e for (k, d), e in main_err.items()}})
    return main_err


def paged_inputs(dev, gen, dtype):
    """The serving path's decode inputs at its last step: 4 sequences of 96
    tokens in 6 contiguous pages of 16, one layer of a 24 + 3 page pool."""
    cfg = get_config(ARCH)
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_seq = -(-(PROMPT + GEN) // PAGE_TOKENS)
    P = BATCH * per_seq + 4 - 1
    table = torch.arange(BATCH * per_seq, dtype=torch.int32).view(BATCH, per_seq).numpy()
    q = torch.randn(BATCH, H, D, generator=gen, device=dev).to(dtype)
    kv = torch.randn(P, PAGE_TOKENS, 2, Kh, D, generator=gen, device=dev).to(dtype)
    lengths = torch.full((BATCH,), PROMPT + GEN, dtype=torch.int32, device=dev)
    return q, kv, lengths, pa.upload_plan(table, 4, dev)


@torch.no_grad()
def phase_serve(dev: torch.device) -> dict:
    cfg = get_config(ARCH)
    args = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
            "--page-tokens", str(PAGE_TOKENS)]
    emit({"phase": "serve_warmup", "note": "2 decode steps: cuBLAS and allocator warm-up"})
    serve.main(args + ["--gen", "2"])             # its model is dropped here
    torch.cuda.empty_cache()
    fa.launches = pa.launches = 0
    res = serve.main(args + ["--gen", str(GEN)])
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.launches, "paged_attention": pa.launches}
    if launches != {"flash_attention": cfg.num_layers,
                    "paged_attention": cfg.num_layers * GEN}:
        raise AssertionError(f"serving path launches {launches}, want "
                             f"{cfg.num_layers} flash and {cfg.num_layers * GEN} paged")
    logits = res.decode_logits.float()
    if tuple(logits.shape) != (BATCH, GEN, cfg.padded_vocab) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"decode logits: shape {tuple(logits.shape)}, or not finite")
    full = res.model(torch.cat([res.prompts, res.fed], dim=1))[:, PROMPT:].float()
    rel = ((full - logits).abs().max() / full.abs().max().clamp(min=1.0)).item()
    if not rel < DECODE_VS_FORWARD_TOL:
        raise AssertionError(f"decode vs forward: relative error {rel:.4f}")
    emit({"phase": "serve", "arch": ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": sum(p.numel() for p in res.model.parameters()),
          "batch": BATCH, "prompt": PROMPT, "gen": GEN, "prefill_s": res.prefill_s,
          "decode_s": res.decode_s, "decode_tok_s": GEN * BATCH / res.decode_s,
          "launches": launches, "decode_vs_forward_rel_err": rel,
          "page_table": res.cache.page_table.tolist(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"launches": launches, "model": res.model, "prompts": res.prompts}


@torch.no_grad()
def phase_profile(model, prompts) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = 8
    cache = model.init_cache(BATCH, PROMPT + steps, page_tokens=PAGE_TOKENS)
    tok = model.prefill(prompts, cache)[:, : model.cfg.vocab_size].argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits = model.decode_step(cache, tok, np.full(BATCH, PROMPT + i))
            tok = logits[:, : model.cfg.vocab_size].argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:     # kernels only: no double count
            continue
        us = getattr(ev, "self_device_time_total", None)
        rows.append({"name": ev.key[:80], "count": ev.count,
                     "device_us": ev.self_cuda_time_total if us is None else us})
    rows.sort(key=lambda r: -r["device_us"])
    busy_us = sum(r["device_us"] for r in rows)
    emit({"phase": "profile", "decode_steps": steps, "wall_ms": wall * 1e3,
          "kernels_per_step": sum(r["count"] for r in rows) / steps,
          "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3) if wall else None,
          "top": rows[:12]})


def phase_kernels(dev: torch.device, main_err: dict, launches: dict) -> None:
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S = BATCH, PROMPT
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    elem = torch.finfo(dt).bits // 8
    flash_bytes = (2 * q.numel() + k.numel() + v.numel()) * elem
    flash_flops = 4 * D * B * H * S * (S + 1) // 2        # causal QK^T and PV
    fb, fby = bound_ms(flash_bytes, flash_flops, dt)
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": launches["flash_attention"],
        "max_abs_err": main_err[("flash", dt)],
        "ms": device_ms(lambda: fa.flash_attention_op(q, k, v, causal=True)),
        "plain_ms": device_ms(lambda: attention_ref(q, k, v, causal=True)),
        "bound_ms": fb, "bound_by": fby,
        "library_ms": device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "shape": {"q": list(q.shape), "kv": list(k.shape), "dtype": "bf16"},
    }
    pq, pkv, lengths, plan = paged_inputs(dev, gen, dt)
    tokens = int(lengths.sum())
    paged_bytes = (2 * pq.numel() + tokens * 2 * Kh * D) * elem \
        + (plan[0].numel() + plan[1].numel() + lengths.numel()) * 4
    pb, pby = bound_ms(paged_bytes, 4 * D * H * tokens, dt)
    paged = {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:108",
        "launches": launches["paged_attention"],
        "max_abs_err": main_err[("paged", dt)],
        "ms": device_ms(lambda: pa.paged_attention(pq, pkv, None, lengths,
                                                   pages_per_block=4, plan=plan)),
        "plain_ms": device_ms(lambda: pa.paged_attention_plain(
            pq, pkv, *plan, lengths, pages_per_block=4)),
        "bound_ms": pb, "bound_by": pby, "library_ms": None,
        "shape": {"q": list(pq.shape), "pool": list(pkv.shape), "tokens": tokens,
                  "dtype": "bf16"},
    }
    emit({"kernels": [flash, paged]})


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    main_err = phase_compare(dev)
    served = phase_serve(dev)
    phase_profile(served["model"], served["prompts"])
    phase_kernels(dev, main_err, served["launches"])
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
