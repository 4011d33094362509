"""Build the flash kernels and check the backward on the card, quickly.

A short first call for a change to ``csrc/flash_attention.cu`` or
``csrc/flash_attention_bwd.cu``: builds every kernel source, prints what
ptxas reports for the two flash sources (registers, spills), then at the
reference suite's flash shapes and the training shapes, in f32 and bf16,
runs the forward with and without the LSE (equal outputs), the LSE and the
backward against their plain versions and the backward twice (equal bits),
one JSON line a case; last, the forward, the forward with the LSE, the
backward and ``scaled_dot_product_attention``'s backward at the training
shape (CUDA events around 20 calls), and the card's name and power limit.
Needs an NVIDIA GPU and nvcc; ``chip_smoke.py`` holds the same to stated
tolerances::

    python tools/flash_bwd_check.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_online)

SHAPES = [   # B, Sq, Skv, H, Kh, D, causal, window
    (2, 128, 128, 4, 2, 32, True, None), (2, 128, 128, 4, 4, 64, False, None),
    (2, 256, 256, 8, 2, 32, True, 96), (2, 64, 192, 2, 2, 32, True, None),
    (2, 64, 64, 2, 1, 128, True, None),                  # tests/test_kernels.py
    (8, 512, 512, 12, 4, 64, True, None),                # rdmabox-paper-100m training
    (2, 100, 100, 6, 2, 64, True, None),                 # ragged tiles
    (2, 64, 192, 4, 2, 64, True, None),                  # Sq < Skv at D 64
    (1, 1280, 1280, 25, 5, 64, True, 1024),              # hymba's window
    (2, 70, 70, 16, 16, 128, False, 33),                 # a window without causality
    (4, 64, 64, 16, 16, 192, True, None),                # deepseek's prefill, D 192
    (1, 300, 300, 4, 4, 192, True, None)]                # D 192, ragged tiles
TRAIN = (8, 512, 12, 4, 64)                              # B, S, H, Kh, D


def events_ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_check: torch sees no CUDA device")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0}))
    for name in ("flash_attention", "flash_attention_bwd"):
        lines = libs[name].with_suffix(".log").read_text().splitlines()
        print(json.dumps({name: [ln.strip()[-120:] for ln in lines
                                 if "Compiling entry" in ln or "Used" in ln or "spill" in ln]}))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, H, Kh, D, causal, window in SHAPES:
            q, do = (torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(B, Skv, Kh, D, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            o, lse = fa._launch(q, k, v, causal, window, with_lse=True)
            same = torch.equal(o, fa._launch(q, k, v, causal, window))
            g1 = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
            g2 = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
            torch.cuda.synchronize()
            ro, rlse = flash_attention_online(q, k, v, causal=causal, window=window,
                                              q_offset=Skv - Sq, return_lse=True)
            ref = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                          q_offset=Skv - Sq)
            print(json.dumps({
                "dtype": str(dtype), "shape": [B, Sq, Skv, H, Kh, D, causal, window],
                "o_same_as_nolse": same, "lse_err": (lse - rlse).abs().max().item(),
                "o_err": (o.float() - ro.float()).abs().max().item(),
                "bitexact": all(torch.equal(a, b) for a, b in zip(g1, g2)),
                "grad_err": [(a.float() - b.float()).abs().max().item()
                             for a, b in zip(g1, ref)],
                "grad_max": [b.float().abs().max().item() for b in ref]}), flush=True)
    B, S, H, Kh, D = TRAIN
    q, do = (torch.randn(B, S, H, D, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Kh, D, device=dev).bfloat16() for _ in range(2))
    o, lse = fa._launch(q, k, v, True, None, with_lse=True)
    qt, kt, vt = (x.repeat_interleave(H // x.shape[2], dim=2).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    print(json.dumps({
        "training_shape": [B, S, H, Kh, D],
        "fwd_ms": events_ms(lambda: fa._launch(q, k, v, True, None)),
        "fwd_lse_ms": events_ms(lambda: fa._launch(q, k, v, True, None, with_lse=True)),
        "bwd_ms": events_ms(lambda: fa._launch_bwd(q, k, v, o, lse, do, True, None)),
        "sdpa_bwd_ms": events_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                             retain_graph=True))}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
