#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile every ``src/repro_torch/csrc/*.cu`` (flash attention forward and
   backward, paged attention, the SSD scan forward and backward) with nvcc for
   sm_90a, one nvcc per source, all started together;
3. model: the analytic backend's calibration against the threaded engine
   (``repro_torch.model.run_calibration``) at the reference suite's point, 4
   clients, 2 donors, 1 worker, paced 1-page writes, with the clients' buffers
   on the card: model/measured throughput and mean latency within ±0.35, no
   predicted saturation, no admission shrink; the same point once more on
   CPU buffers beside it, held the same way; the real time of one engine
   write from each device. A wall-clock measurement, so it runs first, in a
   process that has served no model yet;
4. examples: the four example twins (``repro_torch.examples``) with
   ``--device cuda``, in this process, each ending on its OK line;
   ``serve_paged`` (reduced qwen1.5-0.5b, --spill) launches flash and paged
   attention; ``capacity_plan`` starts no thread and prints the same plan as
   on the CPU;
5. kernels vs plain: each CUDA kernel against its plain PyTorch version on the
   card, at the reference suite's shapes and at the serving shapes (flash
   attention also at a causal prompt of 4096 tokens, at deepseek's prefill at
   head dim 192 and at hymba's, GQA 25/5 with a 1024-token window; paged
   attention also at qwen2-moe's decode, D 128, at its edge cases and at 8192
   tokens of context; the scan also at hymba's prefill, 50 heads, N 16); the
   flash backward and the forward's LSE at the reference suite's shapes, the
   training shape, qwen1.5-0.5b's heads, hymba's window and deepseek's D 192,
   in f32 and bf16, the backward run twice and held to equal bits; the scan's
   training forward (cs summed in f64; y, h_final and the chunk-entry states
   against the plain version's) and its backward at the reference suite's scan
   shapes, ragged tiles and the training shapes of mamba2-780m and hymba-1.5b,
   with and without h_final's cotangent, held to 1e-4 and to equal bits;
6. serve: ``repro_torch.launch.serve.main`` at full width (qwen1.5-0.5b, batch 4,
   prompt 64, 32 decode steps) with every kernel's launch count reset just
   before and read just after; the decode logits against one forward pass over
   prompt + generated tokens;
7. profile: device time by kernel over 8 decode steps (torch.profiler);
8. serve_ssm: the same for mamba2-780m at full width (batch 4, prompt 512 = two
   scan chunks of 256, 256 decode steps), through the SSD chunk-scan kernel;
9. profile_ssm: device time by kernel for one mamba2 prefill and 8 decode steps;
10. ssm_f32: the decode-vs-forward bound for mamba2 on an f32 copy of the served
   weights, over the served tokens (in bf16 the random full-width model
   amplifies rounding past the bound, the JAX reference as much as the port);
11. serve_spill: qwen1.5-0.5b at full width again, with ``--spill --donors 3
   --replication 2 --clients 2``: the ``kv_store`` on the card, donor memory
   pinned on the host; sequence 0's gather byte-exact after its spill and fetch,
   the same kernel launches as ``serve``, no failed transfer, struck donor or
   disk access;
12. kv_spill: a long-context pool through the RDMAbox engine: qwen1.5-0.5b's
   per-layer K/V (2·16·64 bf16 features, 4 KB a token) for 4 sequences of 8192
   tokens in pages of 16 (2048 + 3 pages, 128 MiB on the card) held as a
   ``kv_store``; paged attention over it, every sequence spilled to 3 donors
   and fetched back, paged attention again; spill and fetch rates beside one
   plain ``copy_`` of the same bytes to pinned memory and back;
13. serve_archs: ``serve.main`` at full width for the other archs that fit one
   card (rdmabox-paper-100m, musicgen-large with embedding inputs,
   qwen2-moe-a2.7b, hymba-1.5b with a prompt of 1280 past its 1024-token
   window, deepseek-v2-lite-16b through flash at D 192), each kernel's
   launches reset just before and held to the arch's count just after; the
   32-35 B dense archs and llava-next-34b (65-70 GB of bf16 weights) are not
   served on the card;
14. hybrid_decode: hymba at full width, prefill of 1280, 256 decode steps across
   the ring's wrap, against one forward; held in f32, beside it bf16 through
   the kernels and bf16 with flash and the scan swapped for their plain
   versions, and each bf16 forward against the f32 one;
15. mla_decode: deepseek at full width with every expert routed, prefill of 32
   tokens and 32 absorbed decode steps against one forward; held and witnessed
   as hymba is;
16. train: ``repro_torch.launch.train.main`` at full width (rdmabox-paper-100m,
   batch 8, sequence 512, 30 steps, --offload of the first moment through the
   engine), launches reset just before and held to 12 flash forwards and 12
   flash backwards a step just after, the loss finite at every step and the
   mean of the last 5 below the first 5's by 0.1; step seconds, train tok/s,
   peak device memory; then 2 steps with --remat full (24 forwards a step);
17. train_ssm: ``launch.train.main`` at full width and depth on mamba2-780m
   (batch 8, sequence 512 = two scan chunks, 30 steps), launches held to 48
   scan forwards and 48 scan backwards a step and nothing else, the loss
   finite and falling by 0.1 as in ``train``; step seconds, train tok/s, peak
   device memory and a profile with the scan backward's device ms a step;
18. train_grads: one step of rdmabox-paper-100m (B 8), qwen1.5-0.5b, mamba2-780m
   and hymba-1.5b (B 4) at full width, every parameter's gradient through the
   kernels against the gradient with flash's and the scan's plain versions
   swapped in on the card: held on an f32 copy (finite, nonzero, relative norm
   error ≤ 1e-4), printed in bf16, each arch's launches held;
19. moe_repeat: qwen2-moe-a2.7b at full width, depth cut to 2 of 24 layers,
   B 4, S 512: two forwards and backwards of the loss, the loss and every
   gradient equal in every bit (the MoE combine sums in a fixed order);
20. train_resume: rdmabox-paper-100m's width at 2 layers, 6 straight steps
   against 3 + a checkpoint restore + 3, every parameter and moment equal;
21. kernels: each kernel's time at the serving shapes (CUDA-graph replay, so no
   host gaps), its plain version's, the bound of the card, and a library call's;
   flash attention also at a causal prompt of 4096 tokens (D 64 and D 192), at
   deepseek's and hymba's prefill and at the training shape (with the LSE), the
   flash backward at the training shape, at qwen1.5-0.5b's heads (train_grads'
   shape) and at head dim 192 (library: SDPA's backward), paged
   attention also at qwen2-moe's decode and at 8192 tokens of context (planned
   at R = 4 and R = 1) and at several split counts, the scan also at hymba's
   prefill, the scan's training forward (y in f32 on the CUDA cores, the
   state sweep on the FP64 tensor cores) and backward (FP64 tensor cores)
   at mamba2-780m's training shape (B 8, S 512), the backward also at
   hymba-1.5b's N 16 (B 4); the scan's training rows give the bound at 3×TF32
   and at the FP64 tensor cores they run.

Each phase's seconds are printed as it ends and gathered in a ``phase_seconds``
line. The last line is ``{"ok": true, "device": {...}}``. Any failure raises
and the script exits non-zero; without a CUDA device it fails before printing
anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import box  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.buffers import copy_parts  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, flash_attention_bwd_ref, flash_attention_online)
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked, ssd_ref, ssd_scan_bwd_ref)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.model import ModelWorkload, run_calibration  # noqa: E402

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit. f32-accurate
# products are not bound by the 67 TFLOP/s of the f32 CUDA cores: split into
# three TF32 products (3×TF32, what ssd_scan.cu runs) they go through the
# tensor cores at 495 / 3 = 165 TFLOP/s, so that is the least time for f32 work.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
# The scan's training kernels run their products on the FP64 tensor cores
# (exact products of f32 operands, f64 sums) and on the f32 CUDA cores: 67
# TFLOP/s each, the data sheet's rate. Their rows give the bound at this rate
# beside the 3×TF32 bound above.
FP64_TC_FLOPS = 67e12

ARCH, BATCH, PROMPT, GEN, PAGE_TOKENS = "qwen1.5-0.5b", 4, 64, 32, 16
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
DECODE_VS_FORWARD_TOL = 0.05      # tests/test_models.py's bf16 tolerance
SSM_ARCH, SSM_PROMPT, SSM_GEN = "mamba2-780m", 512, 256
SSD_TOL = 1e-4                    # tests/test_kernels.py::test_ssd_vs_ref
# At the serving shape cs = cumsum(dt·A) runs to −O(100..500) over a chunk of
# 256, and every L_ij = exp(cs_i − cs_j) is a difference of two such sums,
# rounded in another order on each side (a sequential cumsum in the plain
# version, a tree scan in the kernel): ~|cs|·2⁻²⁴ per rounding, a few of them,
# gives L_ij a relative error up to ~1e-4, and y sums 256 × 128 such terms.
SSD_SERVING_TOL = 1e-3
SSD_SHAPES = [     # B, L, H, P, N, chunk (tests/test_kernels.py::test_ssd_vs_ref)
    (2, 128, 3, 16, 8, 32),
    (1, 64, 2, 32, 16, 64),
    (2, 96, 4, 8, 4, 16),
    (1, 256, 1, 64, 32, 64),
]
FLASH_SHAPES = [   # Sq, Skv, H, Kh, D, causal, window (tests/test_kernels.py)
    (128, 128, 4, 2, 32, True, None),
    (128, 128, 4, 4, 64, False, None),
    (256, 256, 8, 2, 32, True, 96),
    (64, 192, 2, 2, 32, True, None),
    (64, 64, 2, 1, 128, True, None),
]
# A long causal prompt (B, S, H = Kh, D): at 64 tokens every attention kernel is
# latency-bound; here the tensor-core products dominate.
LONG_PROMPT = (1, 4096, 16, 64)
# A long decode context (B, tokens, page tokens): the serving shape's 1.8 MB
# pool sits in L2; 134 MB of K/V a layer does not, as at long-context serving.
LONG_DECODE = (4, 8192, 16)
# The other archs' full-width serving runs (phase serve_archs): batch, prompt,
# decode steps, and the launches each kernel must show. hymba's prompt of
# 1280 is a multiple of its 256-token scan chunk, longer than its 1024-token
# window and not a multiple of it, so the ring wraps off its slot 0.
MLA_ARCH, HYBRID_ARCH, MOE_ARCH = "deepseek-v2-lite-16b", "hymba-1.5b", "qwen2-moe-a2.7b"
SERVE_ARCHS = {   # arch: (batch, prompt, gen, {kernel: launches}); serving never
    # launches a backward
    "rdmabox-paper-100m": (4, 64, 32, {"flash_attention": 12, "flash_attention_bwd": 0,
                                       "paged_attention": 384, "ssd_scan": 0,
                                       "ssd_scan_bwd": 0}),
    "musicgen-large": (4, 64, 32, {"flash_attention": 48, "flash_attention_bwd": 0,
                                   "paged_attention": 1536, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0}),
    MOE_ARCH: (4, 64, 32, {"flash_attention": 24, "flash_attention_bwd": 0,
                           "paged_attention": 768, "ssd_scan": 0, "ssd_scan_bwd": 0}),
    HYBRID_ARCH: (4, 1280, 32, {"flash_attention": 32, "flash_attention_bwd": 0,
                                "paged_attention": 0, "ssd_scan": 32, "ssd_scan_bwd": 0}),
    MLA_ARCH: (4, 64, 32, {"flash_attention": 27, "flash_attention_bwd": 0,
                           "paged_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}),
}
# 65-70 GB of bf16 weights each: not served on one 80 GB card
CPU_ONLY_ARCHS = ("command-r-35b", "qwen1.5-32b", "qwen2.5-32b", "llava-next-34b")
HYBRID_DECODE = (1280, 256)       # prefill, then decode across the window's wrap
MLA_DECODE = (32, 32)             # B 1, all experts: prefill, then decode
# A long causal prompt at deepseek's D 192 (B, S, H = Kh, D), off the main path.
LONG_PROMPT_MLA = (1, 4096, 16, 192)
# Training (phases train, train_grads, train_resume): the JAX trainer's
# default arch at full width and depth, its example's batch and sequence.
# One checkpoint (and offload of the first moment) at the last step: posting
# the moment's 121.7K pages takes the host seconds, and in a checkpoint mid-run
# the steps after it wait for it (PERF.md §5).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = (
    "rdmabox-paper-100m", 8, 512, 30, 30)
# train_grads: one step each, S 512. B 4 for the SSM archs: the plain scan's
# (B, K, K, H) f32 tensors are 50 MB a chunk at B 4 (100 MB at B 8), and an f32
# copy of hymba's 1.5B parameters holds 6 GB, its gradients as much again.
GRADS_BATCH = {"rdmabox-paper-100m": 8, ARCH: 4, SSM_ARCH: 4, HYBRID_ARCH: 4}
# train_ssm: mamba2-780m at full width and depth (48 layers, 48 SSM heads × 64,
# state 128, chunk 256), B 8 and S 512: two chunks, so the state's gradient
# crosses a chunk. One checkpoint, after the last step.
SSM_TRAIN_STEPS = 30
# moe_repeat: qwen2-moe-a2.7b at full width (d_model 2048, 60 experts of 1408,
# top 4, 4 shared), its depth cut from 24 layers to 2 so that a bf16 forward
# and backward fit beside the run's other state; B 4, S 512.
MOE_ARCH, MOE_LAYERS, MOE_BATCH = "qwen2-moe-a2.7b", 2, 4
# The flash backward against flash_attention_bwd_ref on the card. f32: both
# sides sum the same f32 products in other orders (on an H100 they differ by
# at most ~1e-6 on gradients up to 9 in magnitude). bf16: both
# compute in f32 from the same bf16 inputs and round each gradient once, so
# they differ by at most one bf16 step (2^-7 relative) where the two f32 sums
# straddle a rounding boundary: inside the forward's 2e-2.
FLASH_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5              # the forward's LSE (|LSE| up to ~10) in f32 on both sides
# Each parameter's gradient through the kernels against the plain versions'
# on f32 copies, ‖g_kernel − g_plain‖ / ‖g_plain‖: the kernels' f32 paths run
# the same f32 arithmetic in another order, through 12-24 layers.
TRAIN_GRAD_TOL = 1e-4
TRAIN_LOSS_DROP = 0.1       # tests/test_system.py::test_training_reduces_loss
# The scan backward against ssd_scan_bwd_ref on the same inputs and states,
# max|a − b| / max(|b|, 1) per gradient: both sum cs, dcs and dA in f64 and the
# rest in f32 in other orders (~4e-7 on an H100 at mamba2's training shape).
SSD_BWD_TOL = 1e-4


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
    B, S, H, D = LONG_PROMPT
    long_prompt = (B, S, S, H, H, D, True, None)
    B, S, H, D = LONG_PROMPT_MLA
    long_mla = (B, S, S, H, H, D, True, None)
    mla, hybrid = flash_mla_shape(), flash_hybrid_shape()
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[dtype]
        shapes = [(2, *s) for s in FLASH_SHAPES] + (
            [long_prompt, long_mla, hybrid] if dtype == torch.bfloat16 else []) + [
            mla, serving]
        for B, Sq, Skv, H, Kh, D, causal, window in shapes:
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
            for name, shape in (("flash_long", long_prompt), ("flash_long_mla", long_mla),
                                ("flash_mla", mla), ("flash_hybrid", hybrid)):
                if (B, Sq, Skv, H, Kh, D, causal, window) == shape:
                    main_err[(name, dtype)] = err
            del q, k, v, out
        main_err[("flash", dtype)] = err          # the serving shape comes last
    report["flash_bwd"], main_err[("flash_train", torch.bfloat16)] = \
        compare_flash_bwd(dev, gen)
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
        for case in paged_edge_cases(dev, gen, dtype):
            report["paged"].append({**check_paged_case(case, tol), "dtype": str(dtype)})
        for name, arch in (("paged_moe", MOE_ARCH), ("paged", ARCH)):
            if name == "paged_moe" and dtype != torch.bfloat16:
                continue
            q, kv, lengths, plan = paged_inputs(dev, gen, dtype, arch)
            out = pa.paged_attention(q, kv, None, lengths, pages_per_block=4, plan=plan)
            torch.cuda.synchronize()
            main_err[(name, dtype)] = max_err(
                out, pa.paged_attention_plain(q, kv, *plan, lengths, pages_per_block=4),
                tol, f"paged {dtype} serving shape, {arch}")
    q, kv, lengths, plans = paged_long_inputs(dev, gen)
    main_err[("paged_long", torch.bfloat16)] = err = max_err(
        pa.paged_attention(q, kv, None, lengths, pages_per_block=4, plan=plans[4][:2],
                           live_blocks=plans[4][2]),
        pa.paged_attention_plain(q, kv, *plans[4][:2], lengths, pages_per_block=4),
        PAGED_TOL[torch.bfloat16], "paged long context")
    report["paged"].append({"case": "long context", "dtype": "torch.bfloat16",
                            "max_abs_err": err})
    del q, kv, lengths, plans
    torch.cuda.empty_cache()
    report["ssd"], main_err[("ssd", torch.float32)], main_err[("ssd_hybrid", torch.float32)] \
        = compare_ssd(dev, gen)
    report["ssd_bwd"] = compare_ssd_bwd(dev, gen)
    emit({"phase": "kernels_vs_plain", **report,
          "serving_shape_max_abs_err": {f"{k}/{d}": e for (k, d), e in main_err.items()}})
    return main_err


def ssd_inputs(dev, gen, B, L, H, P, N, *, model_like=False):
    """tests/test_kernels.py's SSD distributions; ``model_like`` draws dt and
    A as mamba2's mixer makes them (softplus of a projection, −exp(A_log)),
    so exp(cs) underflows to 0 within a chunk of 256."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    x, Bm, Cm = randn(B, L, H, P) * 0.5, randn(B, L, N) * 0.5, randn(B, L, N) * 0.5
    if model_like:
        dt = torch.nn.functional.softplus(randn(B, L, H))
        A = -torch.exp(rand(H) * 1.5)
    else:
        dt = 0.01 + 0.19 * rand(B, L, H)
        A = -(0.5 + 1.5 * rand(H))
    return x, Bm, Cm, dt, A


def ssd_serving_shape(arch: str = SSM_ARCH, prompt: int = SSM_PROMPT):
    cfg = get_config(arch)
    return (BATCH, prompt, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)


def ssd_hybrid_shape():
    """hymba's prefill scan: (4, 1280, 50, 64), N 16, chunk 256."""
    return ssd_serving_shape(HYBRID_ARCH, SERVE_ARCHS[HYBRID_ARCH][1])


def flash_mla_shape():
    """deepseek's prefill: (B, Sq, Skv, H, Kh, D, causal, window), D = qk_nope + qk_rope."""
    cfg = get_config(MLA_ARCH)
    B, S = SERVE_ARCHS[MLA_ARCH][:2]
    D = cfg.qk_nope_dim + cfg.qk_rope_dim
    return (B, S, S, cfg.num_heads, cfg.num_heads, D, True, None)


def flash_hybrid_shape():
    """hymba's prefill: GQA 25/5, D 64, a 1024-token window over 1280 tokens."""
    cfg = get_config(HYBRID_ARCH)
    B, S = SERVE_ARCHS[HYBRID_ARCH][:2]
    return (B, S, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, True, cfg.window)


def compare_ssd(dev, gen) -> tuple[list, float, float]:
    """ssd_scan against ssd_chunked and the sequential ssd_ref, and h_final
    against ssd_chunked's; returns (report, max |err| of y at mamba2's serving
    shape, at hymba's)."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain side in true f32
    report = []

    def check(what, args, chunk, tol, oracle=True):
        y, h = ssd.ssd_scan_op(*args, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        y_plain, h_plain = ssd_chunked(*args, chunk=chunk)
        err = max_err(y, y_plain, tol, f"ssd {what}")
        row = {"case": what, "shape": list(args[0].shape), "N": args[1].shape[-1],
               "chunk": chunk, "tol": tol, "max_abs_err": err,
               "h_final_max_abs_err": max_err(h, h_plain, tol, f"ssd {what} h_final")}
        if oracle:
            row["vs_ssd_ref_max_abs_err"] = max_err(y, ssd_ref(*args), tol,
                                                    f"ssd {what} vs oracle")
        report.append(row)
        return y, err

    for B, L, H, P, N, chunk in SSD_SHAPES:
        check("reference shape", ssd_inputs(dev, gen, B, L, H, P, N), chunk, SSD_TOL)
    # state continuity: splitting L into more chunks changes nothing
    args = ssd_inputs(dev, gen, 1, 128, 2, 8, 4)
    args = (*args[:4], -torch.ones(2, device=dev))
    y16, _ = check("continuity chunk 16", args, 16, SSD_TOL)
    y128, _ = check("continuity chunk 128", args, 128, SSD_TOL)
    report.append({"case": "continuity 16 vs 128",
                   "max_abs_err": max_err(y16, y128, SSD_TOL, "ssd continuity")})
    B, L, H, P, N, K = ssd_serving_shape()
    check("serving shape, test distributions", ssd_inputs(dev, gen, B, L, H, P, N), K,
          SSD_SERVING_TOL)
    _, err = check("serving shape, model-like dt and A",
                   ssd_inputs(dev, gen, B, L, H, P, N, model_like=True), K,
                   SSD_SERVING_TOL, oracle=False)
    B, L, H, P, N, K = ssd_hybrid_shape()
    _, err_hybrid = check("hymba prefill, model-like dt and A",
                          ssd_inputs(dev, gen, B, L, H, P, N, model_like=True), K, SSD_TOL,
                          oracle=False)
    return report, err, err_hybrid


def ssd_bwd_shapes() -> list:
    """(case, B, L, H, P, N, chunk) of the scan backward's checks: the reference
    suite's scan shapes, ragged tiles, and the training shapes of mamba2-780m
    (train_ssm's B 8) and hymba-1.5b (train_grads' B 4), S 512."""
    m, h = get_config(SSM_ARCH), get_config(HYBRID_ARCH)
    return ([("reference shape", *s) for s in SSD_SHAPES] + [
        ("ragged K, N, P", 1, 21, 2, 5, 3, 7),
        ("two row blocks, ragged", 2, 200, 2, 33, 70, 100),
        (f"train: {SSM_ARCH}", TRAIN_BATCH, TRAIN_SEQ, m.ssm_heads, m.ssm_head_dim,
         m.ssm_state, m.ssm_chunk),
        (f"train_grads: {HYBRID_ARCH}", GRADS_BATCH[HYBRID_ARCH], TRAIN_SEQ, h.ssm_heads,
         h.ssm_head_dim, h.ssm_state, h.ssm_chunk)])


def ssd_bwd_rel_errs(grads, plain, what: str) -> dict:
    """max|a − b| / max(|b|, 1) of each of the five gradients, held to SSD_BWD_TOL."""
    out = {}
    for name, g, p in zip(("dx", "dB", "dC", "ddt", "dA"), grads, plain):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what} {name}: non-finite gradient")
        err = ((g - p).abs().max() / p.abs().max().clamp(min=1.0)).item()
        if not err <= SSD_BWD_TOL:
            raise AssertionError(f"{what} {name}: relative error {err:.3e} over {SSD_BWD_TOL}")
        out[name] = err
    return out


def compare_ssd_bwd(dev, gen) -> list:
    """The scan's training forward and its backward against their plain
    versions: y, h_final and the chunk-entry states against ``ssd_chunked``'s
    with cs in f64 (as the training instance sums it) at SSD_TOL, and the
    backward from those states (with and without h_final's cotangent) held
    to SSD_BWD_TOL, run twice and held to equal bits."""
    report = []
    for case, B, L, H, P, N, K in ssd_bwd_shapes():
        x, Bm, Cm, dt, A = ssd_inputs(dev, gen, B, L, H, P, N, model_like=K == 256)
        dy = torch.randn(B, L, H, P, generator=gen, device=dev)
        dh = torch.randn(B, H, N, P, generator=gen, device=dev)
        what = f"ssd bwd {case} {(B, L, H, P, N, K)}"
        y, h, states = ssd._launch(x, Bm, Cm, dt, A, K, True, with_states=True)
        torch.cuda.synchronize()
        y_plain, h_plain, states_plain = ssd_chunked(x, Bm, Cm, dt, A, chunk=K,
                                                     return_states=True, cs64=True)
        row = {"case": case, "shape": [B, L, H, P, N, K], "tol": SSD_BWD_TOL,
               "fwd_tol": SSD_TOL,
               "y_max_abs_err": max_err(y, y_plain, SSD_TOL, what + " y"),
               "h_final_max_abs_err": max_err(h, h_plain, SSD_TOL, what + " h_final"),
               "states_max_abs_err": max_err(states, states_plain, SSD_TOL,
                                             what + " states"),
               "bitwise_repeatable": True}
        for name, cot in (("dh_final", dh), ("no_dh_final", None)):
            grads = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, cot, K)
            again = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, cot, K)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"{what} {name}: two runs gave different bits")
            plain = ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, cot, chunk=K)
            row[f"rel_err_{name}"] = ssd_bwd_rel_errs(grads, plain, f"{what} {name}")
            del grads, again, plain
        report.append(row)
        del x, Bm, Cm, dt, A, dy, dh, y, h, states, y_plain, h_plain, states_plain
    torch.cuda.empty_cache()
    return report


def paged_inputs(dev, gen, dtype, arch: str = ARCH):
    """The serving path's decode inputs at its last step: 4 sequences of 96
    tokens in 6 contiguous pages of 16, one layer of a 24 + 3 page pool, at
    ``arch``'s heads."""
    cfg = get_config(arch)
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_seq = -(-(PROMPT + GEN) // PAGE_TOKENS)
    P = BATCH * per_seq + 4 - 1
    table = torch.arange(BATCH * per_seq, dtype=torch.int32).view(BATCH, per_seq).numpy()
    q = torch.randn(BATCH, H, D, generator=gen, device=dev).to(dtype)
    kv = torch.randn(P, PAGE_TOKENS, 2, Kh, D, generator=gen, device=dev).to(dtype)
    lengths = torch.full((BATCH,), PROMPT + GEN, dtype=torch.int32, device=dev)
    return q, kv, lengths, pa.upload_plan(table, 4, dev)


def paged_long_inputs(dev, gen):
    """A long context off the serving path: qwen1.5-0.5b's heads, bf16, B 4,
    each sequence one contiguous run of 8192 tokens in pages of 16, a pool of
    2048 + 3 pages (134 MB of K/V, beyond the 50 MB L2). Returns q, pool,
    lengths and the plan at R = 4 and R = 1 as (block_start, block_valid,
    live descriptors)."""
    cfg = get_config(ARCH)
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S, T = LONG_DECODE
    per_seq = S // T
    table = np.arange(B * per_seq, dtype=np.int32).reshape(B, per_seq)
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    kv = torch.randn(B * per_seq + 4 - 1, T, 2, Kh, D, generator=gen, device=dev).bfloat16()
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    plans = {}
    for R in (4, 1):
        starts, valid = pa.plan_blocks(table, R)
        dev_plan = torch.from_numpy(np.stack([starts, valid])).to(dev)
        plans[R] = (dev_plan[0], dev_plan[1],
                    pa.count_live_blocks(valid, np.full(B, S), T))
    return q, kv, lengths, plans


def paged_edge_cases(dev, gen, dtype):
    """The paged kernel's edge cases: every G and D, lengths that end mid-page,
    mid-stage and on a split boundary, trailing empty descriptors, a
    fragmented R = 1 table, a pool view at layer 2 of 3, 2 and 4 KV heads a
    CTA, forced splits with splits that hold no live token, and 4096 tokens
    of context with S > 1. Yields dicts of the wrapper's arguments plus
    ``what``, ``splits`` and ``heads`` (None: the wrapper's choice)."""
    rng = np.random.default_rng(5)

    def case(what, B, H, Kh, D, T, R, per_seq, lengths, *, contiguous=True,
             layers=1, splits=None, heads=None):
        P = B * per_seq + 8
        table = -np.ones((B, per_seq + 2), np.int32)   # two trailing empty columns
        pages = (np.arange(B * per_seq) if contiguous else rng.permutation(P)[:B * per_seq])
        table[:, :per_seq] = pages.reshape(B, per_seq)
        pool = torch.randn(layers, P + R - 1, T, 2, Kh, D, generator=gen,
                           device=dev).to(dtype)
        return {"what": what, "q": torch.randn(B, H, D, generator=gen, device=dev).to(dtype),
                "kv": pool[layers - 1], "table": table, "R": R, "splits": splits,
                "heads": heads,
                "lengths": torch.tensor(lengths, dtype=torch.int32, device=dev)}

    for G in (1, 2, 8):
        for D in (32, 64, 128):
            # lengths: full, mid-page, one token
            yield case(f"G {G} D {D}", 3, 2 * G, 2, D, 16, 4, 9, [144, 87, 1])
    # a stage is 16 tokens (f32, D 128) or 32 (bf16): 88 ends mid-stage either way
    yield case("mid-stage", 2, 4, 4, 128, 16, 4, 8, [88, 128])
    # R 1: 12 live descriptors in 4 forced splits of 3, so splits start at
    # 48, 96 and 144 tokens; every length ends on a split boundary
    yield case("split boundary", 3, 4, 2, 64, 16, 1, 16, [48, 96, 192], splits=4)
    yield case("fragmented R 1", 3, 8, 4, 32, 8, 1, 6, [48, 41, 3], contiguous=False)
    yield case("pool layer 2 of 3", 2, 16, 16, 64, 16, 4, 6, [96, 70], layers=3)
    # several KV heads a CTA: one box holds their rows side by side
    yield case("4 heads a CTA, 3 splits", 2, 16, 16, 64, 16, 4, 12, [192, 101], layers=2,
               splits=3, heads=4)
    yield case("2 heads a CTA, G 8 D 128", 2, 16, 2, 128, 16, 2, 9, [144, 33], heads=2)
    # one long and one short sequence: the short one's later splits are empty
    yield case("forced splits, empty splits", 2, 8, 2, 64, 16, 2, 16, [256, 20], splits=8)
    yield case("4096 tokens, S > 1", 2, 8, 4, 64, 16, 4, 256, [4096, 3001])


def check_paged_case(case: dict, tol: float) -> dict:
    """One edge case through the kernel, held to the plain version and the oracle."""
    q, kv, table, lengths, R = (case[k] for k in ("q", "kv", "table", "lengths", "R"))
    B, H, _ = q.shape
    starts, valid = pa.plan_blocks(table, R)
    live = pa.count_live_blocks(valid, lengths.cpu().numpy(), kv.shape[1])
    run_bytes = R * kv.shape[1] * 2 * kv.shape[4] * kv.element_size()
    heads, splits = pa.launch_shape(B, kv.shape[3], live, pa.sm_count(q.device), run_bytes)
    heads, splits = case["heads"] or heads, case["splits"] or splits
    out = pa.paged_attention(q, kv, table, lengths, pages_per_block=R, splits=splits,
                             heads_per_cta=heads, live_blocks=live)
    torch.cuda.synchronize()
    plan = pa.upload_plan(table, R, q.device)
    what = f"paged {q.dtype} {case['what']}"
    err = max_err(out, pa.paged_attention_plain(q, kv, *plan, lengths, pages_per_block=R),
                  tol, what)
    max_err(out, paged_attention_ref(q, kv, torch.from_numpy(table).to(q.device), lengths),
            tol, what + " vs oracle")
    return {"case": case["what"], "H": H, "Kh": kv.shape[3], "D": kv.shape[4], "R": R,
            "heads_per_cta": heads, "splits": splits, "live_blocks": live, "max_abs_err": err}


@torch.no_grad()
def phase_serve(dev: torch.device) -> dict:
    cfg = get_config(ARCH)
    args = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
            "--page-tokens", str(PAGE_TOKENS)]
    emit({"phase": "serve_warmup", "note": "2 decode steps: cuBLAS and allocator warm-up"})
    serve.main(args + ["--gen", "2"])             # its model is dropped here
    torch.cuda.empty_cache()
    reset_launches()
    res = serve.main(args + ["--gen", str(GEN)])
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"flash_attention": cfg.num_layers, "flash_attention_bwd": 0,
            "paged_attention": cfg.num_layers * GEN, "ssd_scan": 0, "ssd_scan_bwd": 0}
    if launches != want:
        raise AssertionError(f"serving path launches {launches}, want {want}")
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


# kernel → (wrapper module, its counter): each adds one where it launches
LAUNCH_COUNTERS = {"flash_attention": (fa, "launches"),
                   "flash_attention_bwd": (fa, "bwd_launches"),
                   "paged_attention": (pa, "launches"), "ssd_scan": (ssd, "launches"),
                   "ssd_scan_bwd": (ssd, "bwd_launches")}


def rel_err(full: torch.Tensor, dec: torch.Tensor) -> float:
    """max|forward − decode| / max(|forward|, 1), tests/test_models.py's measure."""
    full, dec = full.float(), dec.float()
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        raise AssertionError("non-finite logits")
    return ((full - dec).abs().max() / full.abs().max().clamp(min=1.0)).item()


@torch.no_grad()
def phase_serve_archs() -> dict:
    """``serve.main`` at full width for the other archs that fit one card, each
    with its launches reset just before and read just after, its model freed
    before the next; returns arch → launches."""
    from repro_torch.configs import get_config as cfg_of
    t_phase = time.perf_counter()
    out = {}
    for arch, (B, prompt, gen, want) in SERVE_ARCHS.items():
        cfg = cfg_of(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(prompt),
                          "--gen", str(gen)])
        torch.cuda.synchronize()
        launches = read_launches()
        seconds = time.perf_counter() - t0
        if launches != want:
            raise AssertionError(f"{arch}: serving path launches {launches}, want {want}")
        logits = res.decode_logits.float()
        if tuple(logits.shape) != (B, gen, cfg.padded_vocab) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"{arch}: decode logits {tuple(logits.shape)} or not finite")
        out[arch] = launches
        print(f"{arch}: prefill {res.prefill_s:.6f} s, decode {gen * B / res.decode_s:,.1f} "
              f"tok/s, launches {launches}")
        emit({"phase": "serve_archs", "arch": arch, "family": cfg.family,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "params": sum(p.numel() for p in res.model.parameters()),
              "param_count": cfg.param_count(), "cache": type(res.cache).__name__,
              "batch": B, "prompt": prompt, "gen": gen, "embeddings": bool(cfg.frontend),
              "prefill_s": res.prefill_s, "decode_s": res.decode_s,
              "decode_tok_s": gen * B / res.decode_s, "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "seconds": seconds})
        del res, logits
    torch.cuda.empty_cache()
    not_served = {a: {"params": cfg_of(a).param_count(),
                      "bf16_weights_gb": 2 * cfg_of(a).param_count() / 1e9}
                  for a in CPU_ONLY_ARCHS}
    print(f"not served on the card (bf16 weights past one 80 GB card with room): "
          f"{sorted(not_served)}; they serve on the CPU at --reduced")
    emit({"phase": "serve_archs", "not_served": not_served,
          "seconds": time.perf_counter() - t_phase})
    return out


@contextlib.contextmanager
def plain_kernels():
    """Within the block, flash attention and the scan (each forward and
    backward) run their plain versions (those the CPU path runs) on the
    card's tensors, and launch nothing."""
    saved = fa._launch, fa._launch_bwd, ssd._launch, ssd._launch_bwd
    fa._launch = lambda q, k, v, causal, window, with_lse=False: flash_attention_online(
        q, k, v, causal=causal, window=window, q_offset=k.shape[1] - q.shape[1],
        return_lse=with_lse)
    fa._launch_bwd = lambda q, k, v, o, lse, do, causal, window: flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=causal, window=window, q_offset=k.shape[1] - q.shape[1])
    ssd._launch = lambda x, Bm, Cm, dt, A, chunk, return_state, with_states=False: ssd_chunked(
        x, Bm, Cm, dt, A, chunk=chunk, return_states=with_states, cs64=with_states)
    ssd._launch_bwd = lambda x, Bm, Cm, dt, A, states, dy, dh, chunk: ssd_scan_bwd_ref(
        x, Bm, Cm, dt, A, states, dy, dh, chunk=chunk)
    try:
        yield
    finally:
        fa._launch, fa._launch_bwd, ssd._launch, ssd._launch_bwd = saved


# (run, dtype, plain): the serving path in bf16, the same with its prefill
# kernels swapped for their plain versions, and an f32 copy through the kernels
DECODE_RUNS = (("bf16", "bf16", False), ("bf16_plain", "bf16", True), ("f32", "f32", False))


@torch.no_grad()
def decode_vs_forward(cfg, prompt: int, steps: int, seed: int) -> dict:
    """B 1 at full width from seed-0 weights: prefill ``prompt`` tokens, decode
    ``steps`` more one at a time, and run one forward over all of them, for
    each of DECODE_RUNS. Returns each run's decode-vs-forward error and
    launches, each bf16 run's forward against the f32 copy's forward (what
    bf16 alone moves), and the peak device memory in GB."""
    from repro_torch.models import init_transformer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, prompt + steps))).cuda()
    model = init_transformer(cfg, seed=0, device="cuda")
    dvf, fwd, launched = {}, {}, {}
    for run, dtype, plain in DECODE_RUNS:
        if dtype == "f32":
            model.float()
        reset_launches()
        with plain_kernels() if plain else contextlib.nullcontext():
            cache = model.init_cache(1, prompt + steps)
            model.prefill(toks[:, :prompt], cache)
            dec = torch.stack([model.decode_step(cache, toks[:, prompt + i],
                                                 np.array([prompt + i]))
                               for i in range(steps)], dim=1)
            fwd[run] = model(toks)[:, prompt:].float()
            launched[run] = read_launches()
        if (launched[run]["flash_attention"] == 0) != plain:
            raise AssertionError(f"{run}: flash launches {launched[run]}")
        dvf[run] = rel_err(fwd[run], dec)
        del cache, dec
    out = {"decode_vs_forward": dvf, "launches": launched,
           "forward_vs_f32": {run: rel_err(fwd["f32"], fwd[run])
                              for run, dtype, _ in DECODE_RUNS if dtype == "bf16"},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, fwd
    torch.cuda.empty_cache()
    return out


def hold_decode_vs_forward(phase: str, arch: str, res: dict, **facts) -> None:
    """Print ``decode_vs_forward``'s result, hold the f32 copy's error to
    DECODE_VS_FORWARD_TOL (random bf16 weights amplify rounding past it, as
    mamba2's do), emit."""
    dvf = res["decode_vs_forward"]
    print(f"{arch} decode vs forward: "
          + ", ".join(f"{k} {v:.6f}" for k, v in dvf.items())
          + f" (bound {DECODE_VS_FORWARD_TOL}, held in f32); bf16 forward vs f32 forward: "
          + ", ".join(f"{k} {v:.6f}" for k, v in res["forward_vs_f32"].items()))
    if not dvf["f32"] < DECODE_VS_FORWARD_TOL:
        raise AssertionError(f"{arch} decode vs forward in f32: {dvf['f32']:.4f}")
    emit({"phase": phase, "arch": arch, **facts, **res, "held": "f32"})


def phase_hybrid_decode() -> None:
    """hymba across its window's wrap: prefill of 1280 tokens through flash
    (window 1024) and the scan, 256 decode steps over the ring and the SSM
    state, one forward over the 1536 tokens."""
    cfg = get_config(HYBRID_ARCH)
    prompt, steps = HYBRID_DECODE
    res = decode_vs_forward(cfg, prompt, steps, seed=3)
    hold_decode_vs_forward("hybrid_decode", HYBRID_ARCH, res, prefill=prompt,
                           decode=steps, window=cfg.window,
                           ring_slot_of_first_decode=prompt % cfg.window)


def phase_mla_decode() -> None:
    """deepseek with every expert routed (top_k = num_experts, capacity factor
    2.0, as tests/test_models.py pins it: top-k routing is discontinuous):
    prefill of 32 tokens through flash at D 192, 32 absorbed decode steps over
    the latent cache, one forward over the 64 (the f32 copy takes 65 GB)."""
    from repro_torch.configs import replace
    base = get_config(MLA_ARCH)
    cfg = replace(base, top_k=base.num_experts, capacity_factor=2.0)
    prompt, steps = MLA_DECODE
    res = decode_vs_forward(cfg, prompt, steps, seed=4)
    hold_decode_vs_forward("mla_decode", MLA_ARCH, res, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, prefill=prompt,
                           decode=steps)


def reset_launches() -> None:
    for mod, counter in LAUNCH_COUNTERS.values():
        setattr(mod, counter, 0)


def read_launches() -> dict:
    return {name: getattr(mod, counter) for name, (mod, counter) in LAUNCH_COUNTERS.items()}


@torch.no_grad()
def phase_serve_ssm() -> dict:
    """mamba2-780m at full width: prefill of 512 tokens (two scan chunks of
    256, so the state crosses a chunk boundary on the serving path), 256
    greedy decode steps, and a forward over the 768 = 3 × 256 tokens."""
    cfg = get_config(SSM_ARCH)
    args = ["--arch", SSM_ARCH, "--batch", str(BATCH), "--prompt-len", str(SSM_PROMPT)]
    emit({"phase": "serve_ssm_warmup", "note": "2 decode steps: cuBLAS and allocator "
                                               "warm-up"})
    serve.main(args + ["--gen", "2"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = serve.main(args + ["--gen", str(SSM_GEN)])
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"flash_attention": 0, "flash_attention_bwd": 0, "paged_attention": 0,
            "ssd_scan": cfg.num_layers, "ssd_scan_bwd": 0}
    if launches != want:
        raise AssertionError(f"SSM serving path launches {launches}, want {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    logits = res.decode_logits.float()
    if tuple(logits.shape) != (BATCH, SSM_GEN, cfg.padded_vocab) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"SSM decode logits: shape {tuple(logits.shape)}, "
                             "or not finite")
    # recorded, not held to the bound: at 48 layers the random-weight model
    # amplifies bf16 rounding (the JAX reference as much), see phase_ssm_f32
    full = res.model(torch.cat([res.prompts, res.fed], dim=1))[:, SSM_PROMPT:].float()
    rel = ((full - logits).abs().max() / full.abs().max().clamp(min=1.0)).item()
    del full
    emit({"phase": "serve_ssm", "arch": SSM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "ssm_heads": cfg.ssm_heads,
          "ssm_head_dim": cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
          "ssm_chunk": cfg.ssm_chunk, "padded_vocab": cfg.padded_vocab,
          "params": sum(p.numel() for p in res.model.parameters()),
          "batch": BATCH, "prompt": SSM_PROMPT, "gen": SSM_GEN,
          "prefill_s": res.prefill_s, "decode_s": res.decode_s,
          "decode_tok_s": SSM_GEN * BATCH / res.decode_s, "launches": launches,
          "decode_vs_forward_rel_err_bf16": rel, "peak_mem_gb": peak_gb})
    return {"launches": launches, "model": res.model, "prompts": res.prompts,
            "fed": res.fed}


@torch.no_grad()
def phase_ssm_f32(model, prompts, fed) -> None:
    """Decode against the forward with the served weights cast to f32 (in
    place), on the served prompts and fed tokens: prefill of two chunks
    through the kernel, 256 recurrent steps from its final state, and one
    forward over the 768 = 3 × 256 tokens, held to the 0.05 bound."""
    model.float()
    cache = model.init_cache(BATCH, SSM_PROMPT + SSM_GEN)
    model.prefill(prompts, cache)
    dec = torch.stack([model.decode_step(cache, fed[:, i], np.full(BATCH, SSM_PROMPT + i))
                       for i in range(SSM_GEN)], dim=1)
    full = model(torch.cat([prompts, fed], dim=1))[:, SSM_PROMPT:]
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        raise AssertionError("SSM f32 logits not finite")
    err = (full - dec).abs().amax(dim=(0, 2)) / full.abs().max().clamp(min=1.0)
    rel = err.max().item()
    if not rel < DECODE_VS_FORWARD_TOL:
        raise AssertionError(f"SSM decode vs forward in f32: relative error {rel:.4f}")
    emit({"phase": "ssm_f32", "decode_vs_forward_rel_err": rel,
          "rel_err_at_steps": {i: err[i].item() for i in sorted(
              {0, SSM_GEN // 16 - 1, SSM_GEN // 4 - 1, SSM_GEN // 2 - 1, SSM_GEN - 1})}})


def kernel_rows(prof) -> list:
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:     # kernels only: no double count
            continue
        us = getattr(ev, "self_device_time_total", None)
        rows.append({"name": ev.key[:80], "count": ev.count,
                     "device_us": ev.self_cuda_time_total if us is None else us})
    rows.sort(key=lambda r: -r["device_us"])
    return rows


def profiled(fn) -> tuple[list, float]:
    """Kernel rows and host wall seconds of ``fn()``, which ends in a sync."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return kernel_rows(prof), wall


def decode_steps(model, cache, tok, start: int, steps: int) -> None:
    for i in range(steps):
        logits = model.decode_step(cache, tok, np.full(BATCH, start + i))
        tok = logits[:, : model.cfg.vocab_size].argmax(-1)


def profile_summary(rows: list, wall: float, steps: int) -> dict:
    busy_us = sum(r["device_us"] for r in rows)
    return {"wall_ms": wall * 1e3, "kernels_per_step": sum(r["count"] for r in rows) / steps,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3) if wall else None,
            "top": rows[:12]}


@torch.no_grad()
def phase_profile(model, prompts) -> None:
    steps = 8
    cache = model.init_cache(BATCH, PROMPT + steps, page_tokens=PAGE_TOKENS)
    tok = model.prefill(prompts, cache)[:, : model.cfg.vocab_size].argmax(-1)
    torch.cuda.synchronize()
    rows, wall = profiled(lambda: decode_steps(model, cache, tok, PROMPT, steps))
    emit({"phase": "profile", "decode_steps": steps, **profile_summary(rows, wall, steps)})


@torch.no_grad()
def phase_profile_ssm(model, prompts) -> None:
    steps = 8
    cache = model.init_cache(BATCH, SSM_PROMPT + steps)
    out = {}
    rows, wall = profiled(lambda: out.setdefault("logits", model.prefill(prompts, cache)))
    # the ssd_scan source launches two kernels: C·Bᵀ, then the scan
    scan_us = sum(r["device_us"] for r in rows
                  if "ssd_scan_kernel" in r["name"] or "ssd_cb_kernel" in r["name"])
    prefill = profile_summary(rows, wall, 1)
    prefill["ssd_scan_device_ms"] = scan_us / 1e3
    prefill["ssd_scan_share_of_device_time"] = scan_us / 1e3 / prefill["device_busy_ms"]
    tok = out["logits"][:, : model.cfg.vocab_size].argmax(-1)
    rows, wall = profiled(lambda: decode_steps(model, cache, tok, SSM_PROMPT, steps))
    emit({"phase": "profile_ssm", "prefill": prefill, "decode_steps": steps,
          "decode": profile_summary(rows, wall, steps)})


def attended_pairs(S: int, window) -> int:
    """(query, key) pairs a causal prompt of S tokens scores, with an optional window."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_row(dev, gen, B: int, S: int, H: int, Kh: int, D: int, launches: int,
              err: float, case: str, window=None, lse: bool = False) -> dict:
    """The flash kernel's row of the kernels line: causal bf16 prefill of S
    tokens, GQA H/Kh, an optional window; with ``lse`` the training forward,
    which also writes each row's LSE. Its library call is SDPA: with
    ``is_causal`` when every head reads its own KV head and there is no
    window, else with an explicit boolean mask and the KV heads repeated."""
    dt = torch.bfloat16
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt)
    qt, kt, vt = (x.repeat_interleave(H // x.shape[2], dim=2).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    if window is None and H == Kh:
        def library():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                    is_causal=True)
    else:
        pos = torch.arange(S, device=dev)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[None, :] > pos[:, None] - window

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                    attn_mask=mask)
    elem = torch.finfo(dt).bits // 8
    flash_bytes = (2 * q.numel() + k.numel() + v.numel()) * elem + lse * B * H * S * 4
    flash_flops = 4 * D * B * H * attended_pairs(S, window)   # QK^T and PV
    fb, fby = bound_ms(flash_bytes, flash_flops, dt)
    if lse:
        def kernel():
            return fa._launch(q, k, v, True, window, with_lse=True)
    else:
        def kernel():
            return fa.flash_attention_op(q, k, v, causal=True, window=window)
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(kernel),
        "plain_ms": device_ms(lambda: attention_ref(q, k, v, causal=True, window=window),
                              iters=20 if S <= 1024 else 2),
        "bound_ms": fb, "bound_by": fby, "library_ms": device_ms(library),
        "case": case, "shape": {"q": list(q.shape), "kv": list(k.shape), "window": window,
                                "dtype": "bf16", "lse": lse},
    }
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def scan_row(dev, gen, shape: tuple, launches: int, err, case: str,
             training: bool = False) -> dict:
    """The SSD scan's row of the kernels line at (B, L, H, P, N, chunk), f32,
    model-like dt and A, the final state written; with ``training`` the
    training forward (y in f32 on the CUDA cores, the states on the FP64
    tensor cores, cs in f64, the chunk-entry states written), its max |err|
    measured here against
    ``ssd_chunked(..., cs64=True)`` and held to SSD_TOL."""
    B, L, H, P, N, K = shape
    x, Bm, Cm, dt, A = ssd_inputs(dev, gen, B, L, H, P, N, model_like=True)
    sb, sby = bound_ms(*ssd_work(B, L, H, P, N, K, states=training), torch.float32)
    if training:
        def kernel():
            return ssd._launch(x, Bm, Cm, dt, A, K, True, with_states=True)

        def plain():
            return ssd_chunked(x, Bm, Cm, dt, A, chunk=K, return_states=True, cs64=True)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max(max_err(g, w, SSD_TOL, f"ssd training forward {case} {n}")
                  for n, g, w in zip(("y", "h_final", "states"), got, want))
        del got, want
    else:
        def kernel():
            return ssd.ssd_scan_op(x, Bm, Cm, dt, A, chunk=K, return_state=True)

        def plain():
            return ssd_chunked(x, Bm, Cm, dt, A, chunk=K)
    row = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:66",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(kernel), "plain_ms": device_ms(plain),
        "bound_ms": sb, "bound_by": sby, "library_ms": None, "case": case,
        "shape": {"x": list(x.shape), "N": N, "chunk": K, "dtype": "f32", "h_final": True,
                  "states": training},
    }
    if training:    # the bound at the rate of the arithmetic it runs, beside 3×TF32's
        nbytes, flops = ssd_work(B, L, H, P, N, K, states=True)
        row["bound_ms_fp64_tc"] = max(nbytes / HBM_BYTES_PER_S, flops / FP64_TC_FLOPS) * 1e3
        print(f"ssd training forward {case}: {row['ms']:.6f} ms; bound {sb:.6f} ms at "
              f"3×TF32, {row['bound_ms_fp64_tc']:.6f} ms at the FP64 tensor cores and f32 "
              f"CUDA cores it runs")
    del x, Bm, Cm, dt, A
    torch.cuda.empty_cache()
    return row


def scan_bwd_row(dev, gen, shape: tuple, launches: int, case: str) -> dict:
    """The scan backward's row of the kernels line at (B, L, H, P, N, chunk):
    f32, model-like dt and A, from the training instance's states, no h_final
    cotangent (as in training). Held to its plain version (SSD_BWD_TOL, max
    |a − b| / max(|b|, 1) per gradient) and to equal bits on a repeat; its
    max_abs_err is the largest |a − b| of the five gradients."""
    B, L, H, P, N, K = shape
    x, Bm, Cm, dt, A = ssd_inputs(dev, gen, B, L, H, P, N, model_like=True)
    dy = torch.randn(B, L, H, P, generator=gen, device=dev)
    _, _, states = ssd._launch(x, Bm, Cm, dt, A, K, True, with_states=True)
    what = f"ssd bwd row {case}"
    grads = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, None, K)
    again = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, None, K)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{what}: two runs gave different bits")
    plain = ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, None, chunk=K)
    rel = ssd_bwd_rel_errs(grads, plain, what)
    abs_err = max((g - p).abs().max().item() for g, p in zip(grads, plain))
    del grads, again, plain
    nbytes, flops = ssd_bwd_work(B, L, H, P, N, K)
    bb, bby = bound_ms(nbytes, flops, torch.float32)
    _, flops_per_head = ssd_bwd_work(B, L, H, P, N, K, dg_per_head=True)
    row = {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:63",
        "launches": launches, "max_abs_err": abs_err, "rel_err": rel,
        "bitwise_repeatable": True,
        "ms": device_ms(lambda: ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, None, K)),
        "plain_ms": device_ms(lambda: ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, None,
                                                       chunk=K), iters=3),
        "bound_ms": bb, "bound_by": bby, "library_ms": None,
        "fwd_states_ms": device_ms(lambda: ssd._launch(x, Bm, Cm, dt, A, K, True,
                                                       with_states=True)),
        "bound_ms_fp64_tc": max(nbytes / HBM_BYTES_PER_S, flops / FP64_TC_FLOPS) * 1e3,
        "case": case,
        "shape": {"x": list(x.shape), "N": N, "chunk": K, "dtype": "f32",
                  "dh_final": None, "bytes": nbytes, "flops": flops,
                  "flops_dg_per_head": flops_per_head},
    }
    print(f"ssd backward {case}: {row['ms']:.6f} ms; bound {bb:.6f} ms at 3×TF32, "
          f"{row['bound_ms_fp64_tc']:.6f} ms at the FP64 tensor cores it runs "
          f"({flops / 1e9:.2f} GFLOP; {flops_per_head / 1e9:.2f} with dG met per head: "
          f"{flops_per_head / PEAK_FLOPS[torch.float32] * 1e3:.6f} and "
          f"{flops_per_head / FP64_TC_FLOPS * 1e3:.6f} ms)")
    del x, Bm, Cm, dt, A, dy, states
    torch.cuda.empty_cache()
    return row


def paged_row(q, kv, lengths, plan, live_blocks, launches: int, err: float, case: str,
              plain_iters: int = 20) -> dict:
    """The paged kernel's row of the kernels line, R = 4, bf16. Its library call
    is SDPA over strided views of the pool's first B·pages pages: the same
    function only because every table here is one contiguous, full-length run."""
    B, H, D = q.shape
    P, T, _, Kh, _ = kv.shape
    tokens = int(lengths.sum())
    pages = tokens // B // T
    elem = q.element_size()
    nbytes = (2 * q.numel() + tokens * 2 * Kh * D) * elem \
        + (plan[0].numel() + plan[1].numel() + lengths.numel()) * 4
    pb, pby = bound_ms(nbytes, 4 * D * H * tokens, q.dtype)
    seq = kv[:B * pages].view(B, pages * T, 2, Kh, D)
    k_lib, v_lib = seq[:, :, 0].transpose(1, 2), seq[:, :, 1].transpose(1, 2)
    q_lib = q[:, :, None, :]
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:108",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: pa.paged_attention(q, kv, None, lengths, pages_per_block=4,
                                                   plan=plan, live_blocks=live_blocks)),
        "plain_ms": device_ms(lambda: pa.paged_attention_plain(
            q, kv, *plan, lengths, pages_per_block=4), iters=plain_iters),
        "bound_ms": pb, "bound_by": pby,
        "library_ms": device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q_lib, k_lib, v_lib, enable_gqa=H != Kh)),
        "launch_shape": pa.launch_shape(B, Kh, live_blocks or plan[0].shape[1],
                                        pa.sm_count(q.device), 4 * T * 2 * D * elem),
        "case": case, "shape": {"q": list(q.shape), "pool": list(kv.shape),
                                "tokens": tokens, "R": 4, "dtype": str(q.dtype)},
    }


def phase_kernels(dev: torch.device, main_err: dict, launches: dict,
                  kv_spill_launches: int, arch_launches: dict, train_launches: dict,
                  grads_launches: dict, ssm_train_launches: dict) -> None:
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    flash = flash_row(dev, gen, BATCH, PROMPT, H, Kh, D, launches["flash_attention"],
                      main_err[("flash", dt)], "serving: qwen1.5-0.5b prefill")
    B, S, Hl, Dl = LONG_PROMPT
    # same kernel, off the main path: its launches are the main path's
    flash_long = flash_row(dev, gen, B, S, Hl, Hl, Dl, launches["flash_attention"],
                           main_err[("flash_long", dt)], "long prompt, causal")
    B, S, _, Hm, Khm, Dm, _, _ = flash_mla_shape()
    flash_mla = flash_row(dev, gen, B, S, Hm, Khm, Dm,
                          arch_launches[MLA_ARCH]["flash_attention"],
                          main_err[("flash_mla", dt)], f"serving: {MLA_ARCH} prefill, D 192")
    B, S, _, Hh, Khh, Dh, _, W = flash_hybrid_shape()
    flash_hybrid = flash_row(dev, gen, B, S, Hh, Khh, Dh,
                             arch_launches[HYBRID_ARCH]["flash_attention"],
                             main_err[("flash_hybrid", dt)],
                             f"serving: {HYBRID_ARCH} prefill, window {W}", window=W)
    B, S, Hm, Dm = LONG_PROMPT_MLA
    flash_long_mla = flash_row(dev, gen, B, S, Hm, Hm, Dm,
                               arch_launches[MLA_ARCH]["flash_attention"],
                               main_err[("flash_long_mla", dt)], "long prompt, causal, D 192")
    tc = get_config(TRAIN_ARCH)
    flash_train = flash_row(dev, gen, TRAIN_BATCH, TRAIN_SEQ, tc.num_heads, tc.num_kv_heads,
                            tc.head_dim, train_launches["flash_attention"],
                            main_err[("flash_train", dt)],
                            f"training: {TRAIN_ARCH} forward, with the LSE", lse=True)
    flash_bwd = flash_bwd_row(dev, gen, TRAIN_BATCH, TRAIN_SEQ, tc.num_heads,
                              tc.num_kv_heads, tc.head_dim,
                              train_launches["flash_attention_bwd"],
                              f"training: {TRAIN_ARCH} backward (autodiff of "
                              "flash_attention_jnp in the reference)")
    flash_bwd_heads = flash_bwd_row(dev, gen, GRADS_BATCH[ARCH], TRAIN_SEQ, H, Kh, D,
                                    grads_launches[ARCH]["flash_attention_bwd"],
                                    f"train_grads: {ARCH} backward, H = Kh = {H}")
    B, _, _, Hm, Khm, Dm, _, _ = flash_mla_shape()
    # same kernel, off the main path: its launches are the main path's
    flash_bwd_mla = flash_bwd_row(dev, gen, B, TRAIN_SEQ, Hm, Khm, Dm,
                                  train_launches["flash_attention_bwd"],
                                  f"{MLA_ARCH}'s head dim {Dm}, off the main path")
    pq, pkv, lengths, plan = paged_inputs(dev, gen, dt)
    live = -(-(PROMPT + GEN) // (PAGE_TOKENS * 4))   # as the last decode step plans it
    paged = paged_row(pq, pkv, lengths, plan, live, launches["paged_attention"],
                      main_err[("paged", dt)], "serving: qwen1.5-0.5b decode")
    # S = 1 is split_count's choice here; S = 2 beside it
    paged["ms_by_splits"] = {S: device_ms(lambda: pa.paged_attention(
        pq, pkv, None, lengths, pages_per_block=4, plan=plan, live_blocks=live, splits=S))
        for S in (1, 2)}
    del pq, pkv, lengths, plan
    pq, pkv, lengths, plan = paged_inputs(dev, gen, dt, MOE_ARCH)
    paged_moe = paged_row(pq, pkv, lengths, plan, live,
                          arch_launches[MOE_ARCH]["paged_attention"],
                          main_err[("paged_moe", dt)], f"serving: {MOE_ARCH} decode, D 128")
    del pq, pkv, lengths, plan
    pq, pkv, lengths, plans = paged_long_inputs(dev, gen)
    B = pq.shape[0]
    paged_long = paged_row(pq, pkv, lengths, plans[4][:2], plans[4][2],
                           launches["paged_attention"], main_err[("paged_long", dt)],
                           "long context, off the main path", plain_iters=2)
    # the same data planned at R = 1 (one descriptor a page): at the wrapper's
    # launch shape (4 KV heads a CTA share a 16 KB stage) and at R = 4's (one
    # head a CTA), where a stage is one page instead of one 4-page run
    sms = pa.sm_count(dev)
    run_bytes = {R: R * pkv.shape[1] * 2 * D * pkv.element_size() for R in (4, 1)}
    shapes = {R: pa.launch_shape(B, Kh, plans[R][2], sms, run_bytes[R]) for R in (4, 1)}
    paged_long["ms_r1"] = device_ms(lambda: pa.paged_attention(
        pq, pkv, None, lengths, pages_per_block=1, plan=plans[1][:2],
        live_blocks=plans[1][2]))
    paged_long["ms_r1_one_head_a_cta"] = device_ms(lambda: pa.paged_attention(
        pq, pkv, None, lengths, pages_per_block=1, plan=plans[1][:2], live_blocks=plans[1][2],
        heads_per_cta=1, splits=pa.split_count(B * Kh, plans[1][2], sms)))
    paged_long["descriptors"] = {f"R{R}": int((plans[R][1] > 0).sum()) for R in (4, 1)}
    paged_long["launch_shape"] = {f"R{R}": shapes[R] for R in (4, 1)}
    paged_long["launches_kv_spill"] = kv_spill_launches
    del pq, pkv, lengths, plans
    torch.cuda.empty_cache()
    scan = scan_row(dev, gen, ssd_serving_shape(), launches["ssd_scan"],
                    main_err[("ssd", torch.float32)], f"serving: {SSM_ARCH} prefill")
    scan_hybrid = scan_row(dev, gen, ssd_hybrid_shape(),
                           arch_launches[HYBRID_ARCH]["ssd_scan"],
                           main_err[("ssd_hybrid", torch.float32)],
                           f"serving: {HYBRID_ARCH} prefill")
    m, hc = get_config(SSM_ARCH), get_config(HYBRID_ARCH)
    scan_train = scan_row(
        dev, gen, (TRAIN_BATCH, TRAIN_SEQ, m.ssm_heads, m.ssm_head_dim, m.ssm_state,
                   m.ssm_chunk), ssm_train_launches["ssd_scan"], None,
        f"training: {SSM_ARCH} forward (y f32 CUDA cores, states FP64 tensor cores, cs in "
        "f64, chunk-entry states)",
        training=True)
    scan_bwd = scan_bwd_row(
        dev, gen, (TRAIN_BATCH, TRAIN_SEQ, m.ssm_heads, m.ssm_head_dim, m.ssm_state,
                   m.ssm_chunk), ssm_train_launches["ssd_scan_bwd"],
        f"training: {SSM_ARCH} backward (autodiff of ssm_train's lax.scan in the "
        "reference)")
    B = GRADS_BATCH[HYBRID_ARCH]
    scan_bwd_hybrid = scan_bwd_row(
        dev, gen, (B, TRAIN_SEQ, hc.ssm_heads, hc.ssm_head_dim, hc.ssm_state, hc.ssm_chunk),
        grads_launches[HYBRID_ARCH]["ssd_scan_bwd"],
        f"train_grads: {HYBRID_ARCH} backward, N {hc.ssm_state}")
    emit({"kernels": [flash, flash_long, flash_mla, flash_hybrid, flash_long_mla, flash_train,
                      flash_bwd, flash_bwd_heads, flash_bwd_mla, paged, paged_moe,
                      paged_long, scan, scan_hybrid, scan_train, scan_bwd,
                      scan_bwd_hybrid]})


def check_engine_clean(stats: dict, what: str) -> dict:
    """No failed transfer, no struck donor, no disk access: the engine's
    fallbacks must not have carried any part of a run."""
    wc_errors = {n: nic["wc_errors"] for n, nic in stats["nic"].items()}
    paging = {i: c["paging"] for i, c in stats["client"].items()}
    bad = {n: e for n, e in wc_errors.items() if e}
    for i, p in paging.items():
        for key in ("write_failures", "read_failovers", "disk_reads",
                    "disk_writes", "disk_fallback_reads", "evictions"):
            if p[key]:
                bad[f"client {i} {key}"] = p[key]
        if p["failed_donors"]:
            bad[f"client {i} failed_donors"] = p["failed_donors"]
    if stats["fabric"]["faults"]["injected"]:
        bad["injected faults"] = stats["fabric"]["faults"]["injected"]
    if bad:
        raise AssertionError(f"{what}: the engine fell back: {bad}")
    return {"wc_errors": sum(wc_errors.values()),
            "disk": {i: (p["disk_reads"], p["disk_writes"]) for i, p in paging.items()}}


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


@torch.no_grad()
def phase_serve_spill() -> dict:
    """The serving path with the remote-KV tier: the kv_store on the card,
    sequence 0 spilled and fetched while a second client pages to the same
    donors."""
    cfg = get_config(ARCH)
    reset_launches()
    res = serve.main(["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                      "--gen", str(GEN), "--page-tokens", str(PAGE_TOKENS), "--spill",
                      "--donors", "3", "--replication", "2", "--clients", "2"])
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"flash_attention": cfg.num_layers, "flash_attention_bwd": 0,
            "paged_attention": cfg.num_layers * GEN, "ssd_scan": 0, "ssd_scan_bwd": 0}
    if launches != want:
        raise AssertionError(f"serve --spill launches {launches}, want {want}")
    sp = res.spill
    if sp.kv.pool.device.type != "cuda":
        raise AssertionError(f"kv_store pool on {sp.kv.pool.device}, not the card")
    after = sp.kv.gather(0)
    if not same_bytes(after, sp.seq0_before):
        raise AssertionError("serve --spill: sequence 0's gather changed over spill/fetch")
    clean = check_engine_clean(sp.stats, "serve --spill")
    client = sp.stats["client"]["0"]["box"]
    emit({"phase": "serve_spill", "arch": ARCH, "batch": BATCH, "prompt": PROMPT,
          "gen": GEN, "launches": launches, "seq0_tokens": after.shape[0],
          "seq0_bytes_exact": True,
          "rdma_ops": sp.stats["nic"]["0"]["rdma_ops"],
          "merge": client["merge"], "poll": client["poll"],
          "bg_pages_per_s": sp.bg_rates, "decode_tok_s": GEN * BATCH / res.decode_s,
          **clean})
    return launches


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def phase_kv_spill(dev: torch.device) -> int:
    """qwen1.5-0.5b's per-layer K/V at a long context through the engine:
    attention over the pool, every sequence spilled (donors round-robin)
    and fetched back in another order, attention again over the new
    tables; returns the paged kernel's launches in this phase."""
    cfg = get_config(ARCH)
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    (B, S, T), R = LONG_DECODE, 4          # the paged_long row's pool
    features, per_seq = 2 * Kh * D, S // T
    pool_pages = B * per_seq + R - 1
    page_bytes = T * features * 2
    # 3 donors of 256 MiB, the heap arena sized for one whole-pool spill
    spec = box.ClusterSpec(num_donors=3, donor_pages=1 << 16,
                           heap_pages=pool_pages * -(-page_bytes // box.PAGE_SIZE),
                           replication=2, nic_scale=2e-8)
    gen = torch.Generator(device=dev).manual_seed(7)
    t0 = time.perf_counter()
    session = box.open(spec, device=dev)
    open_s = time.perf_counter() - t0
    try:
        kv = session.kv_store(num_pages=pool_pages, page_tokens=T, kv_features=features,
                              dtype=torch.bfloat16)
        for b in range(B):
            kv.add_sequence(b, S)
        # the "kernel" that writes the pool: no synchronize before the spill
        kv.pool.normal_(generator=gen)
        pool = kv.pool.view(pool_pages, T, 2, Kh, D)
        q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)

        def attention():
            table = np.array([kv.tables[b] for b in range(B)], np.int32)
            return table, pa.paged_attention(q, pool, table, lengths, pages_per_block=R)

        reset_launches()
        table0, out0 = attention()
        before = [kv.gather(b).clone() for b in range(B)]
        nbytes = B * per_seq * page_bytes
        spill_ms = host_ms(lambda: [kv.spill(b) for b in range(B)])
        if kv.alloc.free_count != pool_pages:
            raise AssertionError(f"after the spill {pool_pages - kv.alloc.free_count} "
                                 "pool pages are still held")
        # the last two come back to each other's pages, the rest to their own
        order = list(range(B - 2)) + [B - 1, B - 2]
        fetch_ms = host_ms(lambda: [kv.fetch(b) for b in order])
        table1, out1 = attention()
        launches = pa.launches
        exact = [same_bytes(kv.gather(b), before[b]) for b in range(B)]
        if not all(exact):
            raise AssertionError(f"kv_spill: gathers not byte-exact: {exact}")
        same = [bool((table0[b] == table1[b]).all()) for b in range(B)]
        plain = pa.paged_attention_plain(q, pool, *pa.upload_plan(table1, R, dev), lengths,
                                         pages_per_block=R)
        errs = []
        for b in range(B):
            if same[b]:
                if not same_bytes(out1[b], out0[b]):
                    raise AssertionError(f"kv_spill: sequence {b}'s attention changed")
                errs.append(0.0)
            else:
                errs.append(max_err(out1[b], plain[b], PAGED_TOL[torch.bfloat16],
                                    f"kv_spill sequence {b} vs plain"))
        stats = session.stats()
        clean = check_engine_clean(stats, "kv_spill")
        # the copy engine's yardstick: one plain copy_ of the same bytes
        # between the card and pinned host memory, each way
        flat = kv.pool[: B * per_seq].reshape(-1).view(torch.uint8)
        host = torch.empty(flat.numel(), dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        d2h_ms = host_ms(lambda: host.copy_(flat))
        h2d_ms = host_ms(lambda: flat.copy_(host))
        # the engine's own copy pattern without the engine: one copy_ a
        # pool page (64 KB), then one wait, as a merged WQE's copies run
        pages_d2h_ms = host_ms(lambda: copy_parts(
            zip(host.view(-1, page_bytes), flat.view(-1, page_bytes))))
    finally:
        session.close()
    client = stats["client"]["0"]["box"]
    nic = stats["nic"][str(session.clients[0])]
    emit({"phase": "kv_spill", "arch": ARCH, "seqs": B, "tokens": S, "page_tokens": T,
          "kv_features": features, "dtype": "bf16", "pool_pages": pool_pages,
          "pool_mib": kv.pool.numel() * 2 / 2**20, "moved_bytes": nbytes,
          "spec": spec.to_dict(), "open_s": open_s,
          "nic_scale": spec.nic_scale,
          "spill_s": spill_ms / 1e3, "spill_gb_s": nbytes / spill_ms / 1e6,
          "fetch_s": fetch_ms / 1e3, "fetch_gb_s": nbytes / fetch_ms / 1e6,
          "copy_d2h_gb_s": nbytes / d2h_ms / 1e6, "copy_h2d_gb_s": nbytes / h2d_ms / 1e6,
          "copy_per_page_d2h_gb_s": nbytes / pages_d2h_ms / 1e6,
          "requests_submitted": client["merge"]["submitted"], "rdma_ops": nic["rdma_ops"],
          "merge_ratio": client["merge"]["submitted"] / max(1, nic["rdma_ops"]),
          "merge": client["merge"], "poll": {x: client["poll"][x] for x in
                                             ("handled", "wakeups", "poll_calls")},
          "paged_launches": launches, "tables_same": same, "max_abs_err": errs,
          "gathers_exact": exact, **clean})
    return launches


# tests/test_model.py's calibration point, verbatim: PU-heavy costs at a
# coarse clock (1 virtual µs = 4 real µs) so the pacers really sleep
CALIBRATION_SPEC = dict(
    num_donors=2, num_clients=4, donor_pages=4096, replication=1,
    serve_workers=1, nic_scale=4e-6, admission="congestion",
    nic_cost={"wqe_proc_us": 400.0, "wire_us_per_page": 5.0,
              "mmio_us": 0.3, "completion_dma_us": 0.5,
              "reg_kernel_us": 0.12, "dma_read_us": 0.5})
CALIBRATION_WORKLOAD = dict(client_ops_per_s=500.0, read_fraction=0.0, pages_per_op=1)
CALIBRATION_BAND = 0.35
CALIBRATION_OPS = 48


def one_write_us(device: str, n: int = 256) -> float:
    """Real µs of one 1-page engine write and its wait, from a buffer on
    ``device`` (a near-zero clock, so the time is the byte move's own)."""
    spec = box.ClusterSpec(num_donors=1, donor_pages=1024, replication=1, nic_scale=2e-8)
    with box.open(spec, device=device) as s:
        eng, donor = s.engine(0), s.donors[0]
        page = torch.zeros(box.PAGE_SIZE, dtype=torch.uint8, device=s.device)
        for k in range(16):
            eng.write(donor, k, page).wait(30)
        t0 = time.perf_counter()
        for k in range(n):
            eng.write(donor, k % 512, page).wait(30)
        return (time.perf_counter() - t0) / n * 1e6


def phase_model() -> None:
    """The analytic backend against the threaded engine, card then CPU
    buffers, at the reference's calibration point and band."""
    t_phase = time.perf_counter()
    spec = box.ClusterSpec(**CALIBRATION_SPEC)
    wl = ModelWorkload(**CALIBRATION_WORKLOAD)
    rows, failed = {}, []
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = run_calibration(spec, wl, ops_per_client=CALIBRATION_OPS, device=device)
        secs = time.perf_counter() - t0
        print(f"model calibration on {device}: {r.agreement()}; "
              f"p99 model/measured {r.model_p99_us:.1f}/{r.measured_p99_us:.1f} us; "
              f"{secs:.3f} s")
        rows[device] = {
            "throughput_ratio": r.throughput_ratio, "latency_ratio": r.latency_ratio,
            "model_ops_per_s": r.model_ops_per_s, "measured_ops_per_s": r.measured_ops_per_s,
            "model_mean_us": r.model_mean_us, "measured_mean_us": r.measured_mean_us,
            "model_p99_us": r.model_p99_us, "measured_p99_us": r.measured_p99_us,
            "model_saturated": r.model_saturated, "measured_shrinks": r.measured_shrinks,
            "seconds": secs}
        if not (r.within(CALIBRATION_BAND) and not r.model_saturated
                and r.measured_shrinks == 0):
            failed.append(f"{device}: {r.agreement()}")
    moves = {device: one_write_us(device) for device in ("cuda", "cpu")}
    wall = time.perf_counter() - t_phase
    print(f"model phase: {wall:.3f} s")
    emit({"phase": "model", "band": CALIBRATION_BAND, "ops_per_client": CALIBRATION_OPS,
          "spec": spec.to_dict(), "workload": wl.to_dict(), "calibration": rows,
          "one_write_real_us": moves, "seconds": wall})
    if failed:
        raise AssertionError(f"calibration outside ±{CALIBRATION_BAND}, saturated or "
                             f"shrunk: {failed}")


def run_captured(fn, argv: list) -> tuple[object, str, float]:
    """``fn(argv)`` with its standard output captured (and echoed)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = fn(argv)
    finally:
        sys.stdout.write(buf.getvalue())
    return res, buf.getvalue(), time.perf_counter() - t0


def ends_with(out: str, line: str, what: str) -> None:
    if not out.rstrip().endswith(line):
        raise AssertionError(f"{what}: did not end on {line!r}")


@torch.no_grad()
def phase_examples() -> None:
    """The example twins on the card, in this process."""
    from repro_torch.configs import get_reduced
    from repro_torch.examples import capacity_plan, quickstart, remote_paging_demo, serve_paged
    t_phase = time.perf_counter()
    cuda = ["--device", "cuda"]
    seconds = {}
    res, out, seconds["quickstart"] = run_captured(quickstart.main, cuda)
    ends_with(out, "QUICKSTART OK", "quickstart")
    paging, out, seconds["remote_paging_demo"] = run_captured(remote_paging_demo.main, cuda)
    ends_with(out, "REMOTE PAGING DEMO OK", "remote_paging_demo")

    cfg = get_reduced(ARCH)
    reset_launches()
    served, out, seconds["serve_paged"] = run_captured(serve_paged.main, cuda)
    torch.cuda.synchronize()
    launches = read_launches()
    ends_with(out, "SERVING DONE", "serve_paged")
    gen = served.decode_logits.shape[1]
    want = {"flash_attention": cfg.num_layers, "flash_attention_bwd": 0,
            "paged_attention": cfg.num_layers * gen, "ssd_scan": 0, "ssd_scan_bwd": 0}
    if launches != want or not launches["paged_attention"]:
        raise AssertionError(f"serve_paged launches {launches}, want {want}")
    if served.spill is None or served.spill.kv.pool.device.type != "cuda" or not same_bytes(
            served.spill.kv.gather(0), served.spill.seq0_before):
        raise AssertionError("serve_paged: the spilled sequence did not come back exact")
    if not torch.isfinite(served.decode_logits.float()).all():
        raise AssertionError("serve_paged: non-finite decode logits")
    del served

    threads = threading.active_count()
    plan, out, seconds["capacity_plan"] = run_captured(capacity_plan.main, cuda)
    if threading.active_count() != threads:
        raise AssertionError(f"capacity_plan started threads: {threads} -> "
                             f"{threading.active_count()}")
    _, cpu_out, _ = run_captured(capacity_plan.main, ["--device", "cpu"])
    if out != cpu_out:
        raise AssertionError("capacity_plan: card and CPU runs printed different plans")
    verdict = ("cheapest plan meeting the premium p99 target: 16 donors x 4 workers "
               "(cost 68, predicted p99 35.9us <= 60.0us)")
    ends_with(out, verdict, "capacity_plan")
    wall = time.perf_counter() - t_phase
    print(f"examples phase: {wall:.3f} s")
    emit({"phase": "examples", "seconds": seconds, "phase_seconds": wall,
          "serve_paged_launches": launches,
          "paging": {k: paging[k] for k in ("hits", "faults", "evictions",
                                             "readable_after_failure")},
          "quickstart": res, "capacity_plan": {
              "best": plan["best"], "cost": plan["cost"], "p99_us": plan["p99_us"],
              "points": len(plan["rows"]),
              "sweep_eval_ms": sum(r["eval_ms"] for r in plan["rows"]),
              "threads_before_after": [threads, threading.active_count()]}})


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def flash_bwd_shapes() -> list:
    """(case, B, Sq, Skv, H, Kh, D, causal, window) of the backward's checks:
    the reference suite's flash shapes, rdmabox-paper-100m's training shape,
    qwen1.5-0.5b's heads (H = Kh = 16), hymba's window and deepseek's D 192."""
    tc, qc, hc = get_config(TRAIN_ARCH), get_config(ARCH), get_config(HYBRID_ARCH)
    return ([("reference shape", 2, *s) for s in FLASH_SHAPES] + [
        ("train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, tc.num_heads, tc.num_kv_heads,
         tc.head_dim, True, None),
        (f"{ARCH} heads", GRADS_BATCH[ARCH], TRAIN_SEQ, TRAIN_SEQ, qc.num_heads,
         qc.num_kv_heads, qc.head_dim, True, None),
        (f"{HYBRID_ARCH} window", 1, 1280, 1280, hc.num_heads, hc.num_kv_heads, hc.head_dim,
         True, hc.window),
        (f"{MLA_ARCH} D 192", *flash_mla_shape())])


def compare_flash_bwd(dev, gen) -> tuple[list, float]:
    """The forward's LSE and the backward kernel against their plain versions
    in f32 and bf16, the backward run twice and held to equal bits, and the
    forward with the LSE held equal to the forward without it. Returns
    (report, max |err| of the training shape's bf16 forward)."""
    report, fwd_err = [], None
    for case, B, Sq, Skv, H, Kh, D, causal, window in flash_bwd_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(B, Skv, Kh, D, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            what = f"flash bwd {dtype} {case} {(B, Sq, Skv, H, Kh, D, causal, window)}"
            o, lse = fa._launch(q, k, v, causal, window, with_lse=True)
            if not torch.equal(o, fa._launch(q, k, v, causal, window)):
                raise AssertionError(f"{what}: the forward with the LSE differs")
            grads = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
            again = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"{what}: two runs gave different bits")
            o_plain, lse_plain = flash_attention_online(
                q, k, v, causal=causal, window=window, q_offset=Skv - Sq, return_lse=True)
            plain = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                            window=window, q_offset=Skv - Sq)
            tol = FLASH_BWD_TOL[dtype]
            row = {"case": case, "shape": [B, Sq, Skv, H, Kh, D], "causal": causal,
                   "window": window, "dtype": str(dtype), "tol": tol,
                   "lse_max_abs_err": max_err(lse, lse_plain, LSE_TOL, what + " LSE"),
                   "o_max_abs_err": max_err(o, o_plain, FLASH_TOL[dtype], what + " o"),
                   "bitwise_repeatable": True}
            for name, g, p in zip(("dq", "dk", "dv"), grads, plain):
                row[f"{name}_max_abs_err"] = max_err(g, p, tol, f"{what} {name}")
            report.append(row)
            if case == "train" and dtype == torch.bfloat16:
                fwd_err = row["o_max_abs_err"]
            del q, k, v, do, o, lse, grads, again, plain, o_plain, lse_plain
    torch.cuda.empty_cache()
    return report, fwd_err


def train_args(ckpt: Path, steps: int, *extra: str) -> list:
    return ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(steps), "--ckpt-every", str(TRAIN_CKPT_EVERY), "--ckpt-dir",
            str(ckpt), "--log-every", "5", *extra]


def train_launch_counts(arch: str, steps: int, forwards: int = 1) -> dict:
    """The launches of ``steps`` train steps of ``arch``: ``forwards`` forwards
    (2 with --remat full) and one backward a step of flash in every attention
    layer and of the scan in every SSM layer (a hybrid layer has both); no
    paged attention."""
    cfg = get_config(arch)
    attn = 0 if cfg.family == "ssm" else cfg.num_layers
    scan = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": forwards * attn * steps, "flash_attention_bwd": attn * steps,
            "paged_attention": 0, "ssd_scan": forwards * scan * steps,
            "ssd_scan_bwd": scan * steps}


def hold_train_launches(what: str, launches: dict, steps: int, forwards: int,
                        arch: str = TRAIN_ARCH) -> None:
    want = train_launch_counts(arch, steps, forwards)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")


def phase_train() -> dict:
    """``launch.train.main`` at full width (rdmabox-paper-100m, B 8, S 512) with
    --offload, its launches reset just before and held per step just after;
    the loss finite at every step and falling by the reference test's rule.
    Then 2 steps with --remat full (each block's forward runs again in the
    backward). Returns the main run's launches."""
    from repro_torch.launch import train
    cfg = get_config(TRAIN_ARCH)
    ckpt = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, out, wall = run_captured(train.main, train_args(ckpt, TRAIN_STEPS, "--offload"))
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hold_train_launches("train", launches, TRAIN_STEPS, 1)
    ends_with(out, "TRAINING DONE", "train")
    losses = res.losses
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"train: losses {losses}")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if not last < first - TRAIN_LOSS_DROP:
        raise AssertionError(f"train: mean loss of the last 5 steps {last:.4f} not below "
                             f"the first 5's {first:.4f} by {TRAIN_LOSS_DROP}")
    if not res.offload or res.offload["rdma_ops"] <= 0:
        raise AssertionError(f"train --offload: {res.offload}")
    step_s = (res.seconds - res.first_step_s) / (TRAIN_STEPS - 1)
    tokens_a_step = TRAIN_BATCH * TRAIN_SEQ
    print(f"train: {step_s:.6f} s a step after the first ({res.first_step_s:.3f} s), "
          f"{tokens_a_step / step_s:,.0f} tok/s, peak {peak_gb:.2f} GB, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; checkpoint, offload and flush after "
          f"the last step {wall - res.seconds:.3f} s")
    profile = profile_train(res.model, res.opt_state, TRAIN_STEPS, FLASH_TRAIN_KERNELS)
    emit({"phase": "train", "arch": TRAIN_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": sum(p.numel() for p in res.model.parameters()),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "step_s": step_s, "first_step_s": res.first_step_s,
          "train_tok_s": tokens_a_step / step_s, "seconds": res.seconds,
          "after_steps_s": wall - res.seconds, "losses": losses.tolist(),
          "mean_first5": first, "mean_last5": last, "launches": launches,
          "offload": res.offload, "peak_mem_gb": peak_gb, "profile": profile})
    del res
    torch.cuda.empty_cache()
    reset_launches()
    remat_ckpt = ROOT / "build" / "chip_smoke_train_remat"
    shutil.rmtree(remat_ckpt, ignore_errors=True)
    res, out, _ = run_captured(train.main, train_args(remat_ckpt, 2, "--remat", "full"))
    torch.cuda.synchronize()
    remat = read_launches()
    hold_train_launches("train --remat full", remat, 2, 2)
    if not np.isfinite(res.losses).all():
        raise AssertionError(f"train --remat full: losses {res.losses}")
    emit({"phase": "train_remat", "steps": 2, "launches": remat,
          "losses": res.losses.tolist()})
    del res
    for d in (ckpt, remat_ckpt):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def phase_train_ssm() -> dict:
    """``launch.train.main`` at full width and depth on mamba2-780m, B 8, S 512
    (two scan chunks: the state's gradient crosses a chunk), its launches
    reset just before and held per step just after (48 scan forwards and 48
    scan backwards, nothing else); the loss finite at every step and falling
    by the reference test's rule; step seconds, train tok/s, peak device
    memory, and a profile of 2 more steps with the scan backward's device ms
    a step. One checkpoint, after the last step. Returns its launches."""
    from repro_torch.launch import train
    cfg = get_config(SSM_ARCH)
    ckpt = ROOT / "build" / "chip_smoke_train_ssm"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, out, wall = run_captured(train.main, [
        "--arch", SSM_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--steps", str(SSM_TRAIN_STEPS), "--ckpt-every", str(SSM_TRAIN_STEPS + 1),
        "--ckpt-dir", str(ckpt), "--log-every", "5"])
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hold_train_launches("train_ssm", launches, SSM_TRAIN_STEPS, 1, SSM_ARCH)
    ends_with(out, "TRAINING DONE", "train_ssm")
    losses = res.losses
    if len(losses) != SSM_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"train_ssm: losses {losses}")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if not last < first - TRAIN_LOSS_DROP:
        raise AssertionError(f"train_ssm: mean loss of the last 5 steps {last:.4f} not "
                             f"below the first 5's {first:.4f} by {TRAIN_LOSS_DROP}")
    step_s = (res.seconds - res.first_step_s) / (SSM_TRAIN_STEPS - 1)
    tokens_a_step = TRAIN_BATCH * TRAIN_SEQ
    print(f"train_ssm: {step_s:.6f} s a step after the first ({res.first_step_s:.3f} s), "
          f"{tokens_a_step / step_s:,.0f} tok/s, peak {peak_gb:.2f} GB, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; checkpoint after the last step "
          f"{wall - res.seconds:.3f} s")
    shutil.rmtree(ckpt, ignore_errors=True)
    profile = profile_train(res.model, res.opt_state, SSM_TRAIN_STEPS, SSD_TRAIN_KERNELS,
                            "train_ssm")
    emit({"phase": "train_ssm", "arch": SSM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "ssm_heads": cfg.ssm_heads,
          "ssm_head_dim": cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
          "ssm_chunk": cfg.ssm_chunk,
          "params": sum(p.numel() for p in res.model.parameters()),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": SSM_TRAIN_STEPS,
          "step_s": step_s, "first_step_s": res.first_step_s,
          "train_tok_s": tokens_a_step / step_s, "seconds": res.seconds,
          "after_steps_s": wall - res.seconds, "losses": losses.tolist(),
          "mean_first5": first, "mean_last5": last, "launches": launches,
          "peak_mem_gb": peak_gb, "profile": profile})
    del res
    torch.cuda.empty_cache()
    return launches


# train profiles: device ms a step of kernels, by substrings of their names
FLASH_TRAIN_KERNELS = {"flash_bwd_device_ms": ("flash_bwd",),
                       "flash_fwd_device_ms": ("flash_attention_bf16",)}
# (the scan's training forward starts with its f32 C·Bᵀ kernel, the backward
# with its tensor-core one; the third bucket sums both)
SSD_TRAIN_KERNELS = {"ssd_bwd_device_ms": ("ssd_bwd_",),
                     "ssd_fwd_device_ms": ("::fwd_state_kernel(", "::fwd_y_kernel("),
                     "ssd_cb_device_ms": ("::g_kernel(", "::g_f32_kernel(")}


def profile_train(model, opt_state, done: int, kernels: dict, what: str = "train") -> dict:
    """Device time by kernel over 2 train steps after one warm step, from the
    trained model and state after ``done`` steps (torch.profiler), and the
    named kernels' device ms a step."""
    from repro_torch.configs import RunConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import build_train_step
    step_fn = build_train_step(model.cfg, RunConfig(total_steps=done + 3, warmup_steps=10))
    data = SyntheticTokens(DataConfig(model.cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    state = {"opt": opt_state}

    def steps(start: int, n: int) -> None:
        for i in range(n):
            state["opt"], _ = step_fn(model, state["opt"], data.batch_at(start + i))

    steps(done, 1)
    torch.cuda.synchronize()
    rows, wall = profiled(lambda: steps(done + 1, 2))
    out = profile_summary(rows, wall, 2)
    for name, keys in kernels.items():
        out[name] = sum(r["device_us"] for r in rows
                        if any(k in r["name"] for k in keys)) / 1e3 / 2
    out["device_ms_a_step"] = out["device_busy_ms"] / 2
    named = ", ".join(f"{n} {out[n]:.3f}" for n in kernels)
    print(f"{what} profile: {out['wall_ms'] / 2:.3f} ms a step, device busy "
          f"{out['device_ms_a_step']:.3f} ms ({named}), idle share "
          f"{out['device_idle_share']:.3f}, {out['kernels_per_step']:.0f} kernels a step")
    return out


def grads_once(model, tokens, targets, plain: bool) -> tuple[dict, float, dict]:
    """One forward and backward of ``loss_fn``: (gradient by parameter, loss,
    launches); with ``plain`` flash runs its plain versions on the card."""
    from repro_torch.models import loss_fn
    model.zero_grad(set_to_none=True)
    reset_launches()
    with plain_kernels() if plain else contextlib.nullcontext():
        loss, _ = loss_fn(model, tokens, targets)
        loss.backward()
    torch.cuda.synchronize()
    launched = read_launches()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return grads, float(loss), launched


def phase_train_grads() -> dict:
    """Every parameter's gradient through the kernels against the gradient
    with flash and the scan swapped for their plain versions on the card, one
    step at full width of rdmabox-paper-100m, qwen1.5-0.5b, mamba2-780m and
    hymba-1.5b: printed in bf16, held on an f32 copy (finite, nonzero, within
    TRAIN_GRAD_TOL in relative norm), each arch's launches held. Returns each
    arch's kernel launches in its bf16 step."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import init_transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    for arch, B in GRADS_BATCH.items():
        cfg = get_config(arch)
        batch = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, B)).batch_at(0)
        tokens = torch.from_numpy(batch["tokens"]).long().cuda()
        targets = torch.from_numpy(batch["targets"]).long().cuda()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = init_transformer(cfg, seed=0, device="cuda").requires_grad_(True)
        out = {"phase": "train_grads", "arch": arch, "batch": B, "seq": TRAIN_SEQ,
               "tol_f32": TRAIN_GRAD_TOL}
        for dtype in ("bf16", "f32"):
            if dtype == "f32":
                model.float()
            kernel, loss_k, launched_k = grads_once(model, tokens, targets, plain=False)
            plain, loss_p, launched_p = grads_once(model, tokens, targets, plain=True)
            want = train_launch_counts(arch, 1)
            if launched_k != want or any(launched_p.values()):
                raise AssertionError(f"{arch} {dtype}: launches {launched_k} with the "
                                     f"kernels, {launched_p} without")
            errs, norms, unreached = {}, {}, []
            for name, g in kernel.items():
                p = plain[name]
                # an SSM block has no FFN, but carries the reference's norm_ffn
                # leaf: the loss reaches it in neither path (nor in the reference)
                if (g is None and p is None and cfg.family == "ssm"
                        and name.endswith(".norm_ffn")):
                    unreached.append(name)
                    continue
                if g is None or p is None:
                    raise AssertionError(f"{arch} {dtype}: {name} got no gradient")
                gf, pf = g.float(), p.float()
                norms[name] = float(gf.norm())
                errs[name] = float((gf - pf).norm() / pf.norm().clamp(min=1e-30))
                if dtype == "f32" and not (torch.isfinite(gf).all() and norms[name] > 0
                                           and errs[name] <= TRAIN_GRAD_TOL):
                    raise AssertionError(f"{arch} f32 {name}: norm {norms[name]:.3e}, "
                                         f"relative error {errs[name]:.3e}")
            worst = max(errs, key=errs.get)
            print(f"train_grads {arch} {dtype}: {len(errs)} parameters, worst relative "
                  f"error {errs[worst]:.3e} ({worst}), loss {loss_k:.6f} vs plain "
                  f"{loss_p:.6f}" + (" (held)" if dtype == "f32" else ""))
            out[dtype] = {"parameters": len(errs), "unreached": unreached,
                          "max_rel_err": errs[worst],
                          "worst": worst, "min_grad_norm": min(norms.values()),
                          "loss_kernels": loss_k, "loss_plain": loss_p,
                          "mixer_rel_err": {n: e for n, e in errs.items()
                                            if n.startswith("blocks.0.")
                                            and (".attn." in n or ".ssm." in n)},
                          "launches": launched_k}
            launches.setdefault(arch, launched_k)
            del kernel, plain
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        emit(out)
        del model
        torch.cuda.empty_cache()
    return launches


def phase_moe_repeat() -> None:
    """The MoE layer repeats bit for bit on the card: ``loss_fn``'s forward and
    backward of qwen2-moe-a2.7b at full width (depth cut to MOE_LAYERS) twice
    on the same weights and batch, the loss and every parameter's gradient
    equal in every bit. Its combine and the dispatch's backward are gathers
    summed over each token's slots in a fixed order (``models/moe.py``);
    ``index_add_`` there would add with atomics."""
    from repro_torch.configs import replace
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import init_transformer, loss_fn
    full = get_config(MOE_ARCH)
    cfg = replace(full, num_layers=MOE_LAYERS)
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, MOE_BATCH)).batch_at(0)
    tokens = torch.from_numpy(batch["tokens"]).long().cuda()
    targets = torch.from_numpy(batch["targets"]).long().cuda()
    torch.cuda.empty_cache()
    model = init_transformer(cfg, seed=0, device="cuda").requires_grad_(True)
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, tokens, targets)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach().clone(),
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}))
    (loss_a, grads_a), (loss_b, grads_b) = runs
    differ = [n for n, g in grads_a.items() if not torch.equal(g, grads_b[n])]
    if not torch.equal(loss_a, loss_b) or differ or set(grads_a) != set(grads_b):
        raise AssertionError(f"moe_repeat: loss {loss_a.item()!r} then {loss_b.item()!r}, "
                             f"gradients that differ: {differ[:5]}")
    moe_grads = [n for n in grads_a if ".moe." in n]
    if not moe_grads or not all(torch.isfinite(grads_a[n]).all() for n in moe_grads):
        raise AssertionError(f"moe_repeat: MoE gradients {moe_grads[:5]}")
    print(f"moe_repeat: {MOE_ARCH} at depth {MOE_LAYERS} of {full.num_layers} (full width), "
          f"B {MOE_BATCH}, S {TRAIN_SEQ}: loss and {len(grads_a)} gradients equal in every "
          f"bit across two forward and backward runs")
    emit({"phase": "moe_repeat", "arch": MOE_ARCH, "layers": MOE_LAYERS,
          "full_layers": full.num_layers, "d_model": cfg.d_model,
          "experts": cfg.num_experts, "top_k": cfg.top_k, "batch": MOE_BATCH,
          "seq": TRAIN_SEQ, "loss": float(loss_a), "gradients": len(grads_a),
          "moe_gradients": len(moe_grads), "bitwise_equal": True})
    del model, runs, grads_a, grads_b
    torch.cuda.empty_cache()


def phase_train_resume() -> None:
    """Bit-exact resume on the card: rdmabox-paper-100m's width with 2 layers,
    6 straight steps against 3, a checkpoint, a new process state restored
    from it, and 3 more; ``torch.equal`` on every parameter and moment."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import RunConfig, replace
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import init_transformer
    from repro_torch.optim import adamw
    cfg = replace(get_config(TRAIN_ARCH), num_layers=2)
    run = RunConfig(learning_rate=3e-4, total_steps=6, warmup_steps=2)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    root = ROOT / "build" / "chip_smoke_resume"
    shutil.rmtree(root, ignore_errors=True)

    def steps(start: int, stop: int, ckpt: Checkpointer, resume: bool):
        model = init_transformer(cfg, seed=0, device="cuda").requires_grad_(True)
        params = dict(model.named_parameters())
        opt = adamw.init(params, run)
        if resume:
            at, (saved, opt), _ = ckpt.restore_latest((params, opt))
            if at != start:
                raise AssertionError(f"train_resume: restored step {at}, want {start}")
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])
        step_fn = build_train_step(cfg, run)
        for step in range(start, stop):
            opt, _ = step_fn(model, opt, data.batch_at(step))
        ckpt.save(stop, (params, opt))
        return model, opt

    straight, opt_a = steps(0, 6, Checkpointer(str(root / "a"), keep=1), False)
    ck = Checkpointer(str(root / "b"), keep=1)
    steps(0, 3, ck, False)
    resumed, opt_b = steps(3, 6, ck, True)
    torch.cuda.synchronize()
    params = [n for (n, a), b in zip(straight.named_parameters(), resumed.parameters())
              if not torch.equal(a, b)]
    moments = [n for n in opt_a.m if not (torch.equal(opt_a.m[n], opt_b.m[n])
                                          and torch.equal(opt_a.v[n], opt_b.v[n]))]
    shutil.rmtree(root, ignore_errors=True)
    if params or moments:
        raise AssertionError(f"train_resume: not bit-exact: parameters {params}, "
                             f"moments {moments}")
    emit({"phase": "train_resume", "arch": TRAIN_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "steps": "6 straight vs 3 + resume 3", "bit_exact": True,
          "parameters": len(list(straight.parameters()))})
    del straight, resumed, opt_a, opt_b
    torch.cuda.empty_cache()


def flash_bwd_row(dev, gen, B: int, S: int, H: int, Kh: int, D: int, launches: int,
                  case: str) -> dict:
    """A row of the kernels line for the flash backward: causal bf16, S
    tokens, GQA H/Kh, head dim D. Its max |err| is against the plain backward
    on the same inputs, held to FLASH_BWD_TOL. Bound: q, k, v, o, dO, LSE, Δ
    read and dq, dk, dv written once, and five products of 2·D flops a
    visible (query, key) pair. Library: the backward of
    ``scaled_dot_product_attention`` (flash, ``is_causal``) on the same
    tensors with the KV heads repeated (its dk, dv stay per query head): a
    CUDA graph of its forward and backward less one of its forward alone."""
    dt = torch.bfloat16
    q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dt) for _ in range(2))
    k, v = (torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt) for _ in range(2))
    o, lse = fa._launch(q, k, v, True, None, with_lse=True)
    what = f"flash bwd row {case}"
    grads = fa._launch_bwd(q, k, v, o, lse, do, True, None)
    torch.cuda.synchronize()
    plain = flash_attention_bwd_ref(q, k, v, o, lse, do)
    err = max(max_err(g, p, FLASH_BWD_TOL[dt], f"{what} {n}")
              for n, g, p in zip(("dq", "dk", "dv"), grads, plain))
    del grads, plain
    elem = torch.finfo(dt).bits // 8
    nbytes = (4 * q.numel() + 4 * k.numel()) * elem + 2 * lse.numel() * 4
    flops = 10 * D * B * H * attended_pairs(S, None)
    bb, bby = bound_ms(nbytes, flops, dt)
    qt, kt, vt = (x.repeat_interleave(H // x.shape[2], dim=2).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    with torch.no_grad():
        sdpa_fwd_ms = device_ms(sdpa)
    sdpa_both_ms = device_ms(sdpa_fwd_bwd)
    row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:65",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: fa._launch_bwd(q, k, v, o, lse, do, True, None)),
        "plain_ms": device_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do)),
        "bound_ms": bb, "bound_by": bby, "library_ms": sdpa_both_ms - sdpa_fwd_ms,
        "library_fwd_bwd_ms": sdpa_both_ms, "library_fwd_ms": sdpa_fwd_ms,
        "case": case,
        "shape": {"q": list(q.shape), "kv": list(k.shape), "dtype": "bf16",
                  "bytes": nbytes, "flops": flops},
    }
    del q, k, v, do, o, lse, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return row


def ssd_work(B: int, L: int, H: int, P: int, N: int, K: int,
             states: bool = False) -> tuple[int, int]:
    """(bytes, flops) of one SSD scan with the final state written (and, with
    ``states``, the state entering each chunk).

    Bytes: x, Bm, Cm, dt and A read once, y and h_final (and the states)
    written once (f32).
    Flops, per (b, chunk): C·Bᵀ over the causal half, K(K+1)/2 dots of N,
    once (it is shared by every head); per (b, h, chunk): the masked scores
    times x over the causal half (P per score), C·h_prev (K·N·P) and the
    state update (K·N·P); 2 flops a multiply-add. Elementwise work (the
    scan of dt·A, the exps, the masks) is left out.
    """
    n_chunks, tri = L // K, K * (K + 1) // 2
    flops = 2 * B * n_chunks * (N * tri + H * (P * tri + 2 * K * N * P))
    nbytes = 4 * (2 * B * L * H * P + 2 * B * L * N + B * L * H + H + B * H * N * P
                  + states * B * n_chunks * H * N * P)
    return nbytes, flops


def ssd_bwd_work(B: int, L: int, H: int, P: int, N: int, K: int,
                 dg_per_head: bool = False) -> tuple[int, int]:
    """(bytes, flops) of one scan backward with no h_final cotangent.

    Bytes: x, dy, Bm, Cm, dt, A and the chunk-entry states read once, dx, dB,
    dC, ddt and dA written once (f32). Flops, per (b, chunk): C·Bᵀ over the
    causal half, K(K+1)/2 dots of N, once (shared by every head), and dGₛ·B
    and dGₛᵀ·C (N a pair each over the causal half), dGₛ = Σ_h dG summed over
    heads first, since B and C are shared by every head; per (b, h, chunk),
    over the causal half: dW = dy·xᵀ and Wᵀ·dy (P a pair each); and B·dh,
    dh·x, h⁻·dy, C·h⁻ and the state's gradient Cᵀ·dy (K·N·P each), u and the
    inbound dcs term (K·P each); 2 flops a multiply-add. Elementwise work (the
    scans of dt·A and dcs, the exps, the masks) is left out. With
    ``dg_per_head`` the count of a backward that meets each head's dG with B
    and C on its own (PR 20's kernel: 32.5 GFLOP at mamba2's training shape).
    """
    n_chunks, tri = L // K, K * (K + 1) // 2
    if dg_per_head:
        flops = 2 * B * n_chunks * (N * tri + H * (2 * P * tri + 2 * N * tri + 4 * K * N * P
                                                   + 2 * K * N))
    else:
        flops = 2 * B * n_chunks * (3 * N * tri + H * (2 * P * tri + 5 * K * N * P
                                                       + 2 * K * P))
    nbytes = 4 * (3 * B * L * H * P + 4 * B * L * N + 2 * B * L * H + 2 * H
                  + B * n_chunks * H * N * P)
    return nbytes, flops


PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its seconds printed and kept for the summary line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_SECONDS[name]:.3f} s", flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    timed("model", phase_model)
    timed("examples", phase_examples)
    torch.cuda.empty_cache()
    main_err = timed("kernels_vs_plain", phase_compare, dev)
    served = timed("serve", phase_serve, dev)
    timed("profile", phase_profile, served["model"], served["prompts"])
    launches = served["launches"]
    del served                                    # free qwen's weights and pool
    torch.cuda.empty_cache()
    served = timed("serve_ssm", phase_serve_ssm)
    timed("profile_ssm", phase_profile_ssm, served["model"], served["prompts"])
    timed("ssm_f32", phase_ssm_f32, served["model"], served["prompts"], served["fed"])
    launches["ssd_scan"] = served["launches"]["ssd_scan"]
    del served
    torch.cuda.empty_cache()
    timed("serve_spill", phase_serve_spill)
    torch.cuda.empty_cache()
    kv_spill_launches = timed("kv_spill", phase_kv_spill, dev)
    torch.cuda.empty_cache()
    arch_launches = timed("serve_archs", phase_serve_archs)
    timed("hybrid_decode", phase_hybrid_decode)
    timed("mla_decode", phase_mla_decode)
    train_launches = timed("train", phase_train)
    ssm_train_launches = timed("train_ssm", phase_train_ssm)
    grads_launches = timed("train_grads", phase_train_grads)
    timed("moe_repeat", phase_moe_repeat)
    timed("train_resume", phase_train_resume)
    timed("kernels", phase_kernels, dev, main_err, launches, kv_spill_launches,
          arch_launches, train_launches, grads_launches, ssm_train_launches)
    emit({"phase_seconds": PHASE_SECONDS, "total_s": time.perf_counter() - t_start})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
