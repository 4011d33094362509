#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile every ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a, one
   nvcc per source, all started together;
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
   attention also at a causal prompt of 4096 tokens; paged attention also at
   its edge cases and at 8192 tokens of context);
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
13. kernels: each kernel's time at the serving shapes (CUDA-graph replay, so no
   host gaps), its plain version's, the bound of the card, and a library call's;
   flash attention also at a causal prompt of 4096 tokens, paged attention also
   at 8192 tokens of context (planned at R = 4 and R = 1) and at several split
   counts.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and the
script exits non-zero; without a CUDA device it fails before printing anything.
"""

from __future__ import annotations

import contextlib
import io
import json
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
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.model import ModelWorkload, run_calibration  # noqa: E402

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit. f32-accurate
# products are not bound by the 67 TFLOP/s of the f32 CUDA cores: split into
# three TF32 products (3×TF32, what ssd_scan.cu runs) they go through the
# tensor cores at 495 / 3 = 165 TFLOP/s, so that is the least time for f32 work.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}

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
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[dtype]
        shapes = [(2, *s) for s in FLASH_SHAPES] + (
            [long_prompt] if dtype == torch.bfloat16 else []) + [serving]
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
            if (B, Sq, Skv, H, Kh, D, causal, window) == long_prompt:
                main_err[("flash_long", dtype)] = err
            del q, k, v, out
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
        for case in paged_edge_cases(dev, gen, dtype):
            report["paged"].append({**check_paged_case(case, tol), "dtype": str(dtype)})
        q, kv, lengths, plan = paged_inputs(dev, gen, dtype)
        out = pa.paged_attention(q, kv, None, lengths, pages_per_block=4, plan=plan)
        torch.cuda.synchronize()
        main_err[("paged", dtype)] = max_err(
            out, pa.paged_attention_plain(q, kv, *plan, lengths, pages_per_block=4),
            tol, f"paged {dtype} serving shape")
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
    report["ssd"], main_err[("ssd", torch.float32)] = compare_ssd(dev, gen)
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


def ssd_serving_shape():
    cfg = get_config(SSM_ARCH)
    return (BATCH, SSM_PROMPT, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk)


def compare_ssd(dev, gen) -> tuple[list, float]:
    """ssd_scan against ssd_chunked and the sequential ssd_ref, and h_final
    against ssd_chunked's; returns (report, serving-shape max |err| of y)."""
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
    return report, err


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
    want = {"flash_attention": cfg.num_layers, "paged_attention": cfg.num_layers * GEN,
            "ssd_scan": 0}
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


LAUNCH_COUNTERS = {"flash_attention": fa, "paged_attention": pa, "ssd_scan": ssd}


def reset_launches() -> None:
    for mod in LAUNCH_COUNTERS.values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in LAUNCH_COUNTERS.items()}


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
    want = {"flash_attention": 0, "paged_attention": 0, "ssd_scan": cfg.num_layers}
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


def flash_row(dev, gen, B: int, S: int, H: int, Kh: int, D: int, launches: int,
              err: float, case: str) -> dict:
    """The flash kernel's row of the kernels line: causal bf16 prefill of S tokens."""
    dt = torch.bfloat16
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    elem = torch.finfo(dt).bits // 8
    flash_bytes = (2 * q.numel() + k.numel() + v.numel()) * elem
    flash_flops = 4 * D * B * H * S * (S + 1) // 2        # causal QK^T and PV
    fb, fby = bound_ms(flash_bytes, flash_flops, dt)
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: fa.flash_attention_op(q, k, v, causal=True)),
        "plain_ms": device_ms(lambda: attention_ref(q, k, v, causal=True),
                              iters=20 if S <= 1024 else 2),
        "bound_ms": fb, "bound_by": fby,
        "library_ms": device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "case": case, "shape": {"q": list(q.shape), "kv": list(k.shape), "dtype": "bf16"},
    }
    del q, k, v, qt, kt, vt
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
                  kv_spill_launches: int) -> None:
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
    pq, pkv, lengths, plan = paged_inputs(dev, gen, dt)
    live = -(-(PROMPT + GEN) // (PAGE_TOKENS * 4))   # as the last decode step plans it
    paged = paged_row(pq, pkv, lengths, plan, live, launches["paged_attention"],
                      main_err[("paged", dt)], "serving: qwen1.5-0.5b decode")
    # S = 1 is split_count's choice here; S = 2 beside it
    paged["ms_by_splits"] = {S: device_ms(lambda: pa.paged_attention(
        pq, pkv, None, lengths, pages_per_block=4, plan=plan, live_blocks=live, splits=S))
        for S in (1, 2)}
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
    x, Bm, Cm, dt_, A = ssd_inputs(dev, gen, *ssd_serving_shape()[:5], model_like=True)
    B_, L_, H_, P_, N_, K_ = ssd_serving_shape()
    sb, sby = bound_ms(*ssd_work(B_, L_, H_, P_, N_, K_), torch.float32)
    scan = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:66",
        "launches": launches["ssd_scan"],
        "max_abs_err": main_err[("ssd", torch.float32)],
        "ms": device_ms(lambda: ssd.ssd_scan_op(x, Bm, Cm, dt_, A, chunk=K_,
                                                return_state=True)),
        "plain_ms": device_ms(lambda: ssd_chunked(x, Bm, Cm, dt_, A, chunk=K_)),
        "bound_ms": sb, "bound_by": sby, "library_ms": None,
        "shape": {"x": list(x.shape), "N": N_, "chunk": K_, "dtype": "f32",
                  "h_final": True},
    }
    emit({"kernels": [flash, flash_long, paged, paged_long, scan]})


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
    want = {"flash_attention": cfg.num_layers, "paged_attention": cfg.num_layers * GEN,
            "ssd_scan": 0}
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
    want = {"flash_attention": cfg.num_layers, "paged_attention": cfg.num_layers * gen,
            "ssd_scan": 0}
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


def ssd_work(B: int, L: int, H: int, P: int, N: int, K: int) -> tuple[int, int]:
    """(bytes, flops) of one SSD scan with the final state written.

    Bytes: x, Bm, Cm, dt and A read once, y and h_final written once (f32).
    Flops, per (b, chunk): C·Bᵀ over the causal half, K(K+1)/2 dots of N,
    once (it is shared by every head); per (b, h, chunk): the masked scores
    times x over the causal half (P per score), C·h_prev (K·N·P) and the
    state update (K·N·P); 2 flops a multiply-add. Elementwise work (the
    scan of dt·A, the exps, the masks) is left out.
    """
    n_chunks, tri = L // K, K * (K + 1) // 2
    flops = 2 * B * n_chunks * (N * tri + H * (P * tri + 2 * K * N * P))
    nbytes = 4 * (2 * B * L * H * P + 2 * B * L * N + B * L * H + H + B * H * N * P)
    return nbytes, flops


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_model()
    phase_examples()
    torch.cuda.empty_cache()
    main_err = phase_compare(dev)
    served = phase_serve(dev)
    phase_profile(served["model"], served["prompts"])
    launches = served["launches"]
    del served                                    # free qwen's weights and pool
    torch.cuda.empty_cache()
    served = phase_serve_ssm()
    phase_profile_ssm(served["model"], served["prompts"])
    phase_ssm_f32(served["model"], served["prompts"], served["fed"])
    launches["ssd_scan"] = served["launches"]["ssd_scan"]
    del served
    torch.cuda.empty_cache()
    phase_serve_spill()
    torch.cuda.empty_cache()
    kv_spill_launches = phase_kv_spill(dev)
    torch.cuda.empty_cache()
    phase_kernels(dev, main_err, launches, kv_spill_launches)
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
