"""Build the scan kernels and check the scan's backward on the card, quickly.

A short first call for a change to ``csrc/ssd_scan.cu`` or
``csrc/ssd_scan_bwd.cu``: builds every kernel source, prints what ptxas
reports for the two scan sources (registers, spills), then at the card-only
tests' scan shapes (ragged K, N and P), at mamba2-780m's training shape and
at hymba-1.5b's N 16, one JSON line a case: the forward's training instance
(cs summed in f64: y, h_final and the chunk-entry states against
``ssd_chunked(..., cs64=True)``'s; y against serving's instance's, which
sums cs in f32), the backward against ``ssd_scan_bwd_ref`` on the same
states (max|a − b| / max(|b|, 1) per gradient), with and without an h_final
cotangent, run twice (equal bits); one gradient through ``ssd_scan_op``
with the launches counted; last, the backward's time, the plain backward's
and the forward's at the training shapes (CUDA events around repeated
calls), and the card's name and power limit. Needs an NVIDIA GPU and nvcc;
``chip_smoke.py`` holds the same to stated tolerances::

    python tools/ssd_bwd_check.py
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
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_bwd_ref  # noqa: E402

SHAPES = [   # B, L, H, P, N, chunk
    (2, 128, 3, 16, 8, 32), (1, 64, 2, 32, 16, 64), (2, 96, 4, 8, 4, 16),
    (1, 256, 1, 64, 32, 64),                             # tests/test_kernels.py
    (1, 96, 2, 24, 12, 48), (2, 64, 3, 8, 4, 16), (1, 40, 2, 12, 6, 8),
    (1, 21, 2, 5, 3, 7),                                 # ragged tiles
    (2, 200, 2, 33, 70, 100),                            # two row blocks, ragged
    (1, 512, 3, 64, 128, 256)]                           # full widths, two chunks
TRAIN = [(8, 512, 48, 64, 128, 256),                     # mamba2-780m, B 8, S 512
         (4, 512, 50, 64, 16, 256)]                      # hymba-1.5b, B 4


def inputs(gen, B, L, H, P, N):
    """mamba2's mixer's distributions: dt = softplus(·), A = −exp(·)."""
    dev = torch.device("cuda")
    x = torch.randn(B, L, H, P, generator=gen, device=dev) * 0.5
    Bm, Cm = (torch.randn(B, L, N, generator=gen, device=dev) * 0.5 for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(B, L, H, generator=gen, device=dev))
    A = -torch.exp(torch.rand(H, generator=gen, device=dev) * 1.5)
    dy = torch.randn(B, L, H, P, generator=gen, device=dev)
    dh = torch.randn(B, H, N, P, generator=gen, device=dev)
    return x, Bm, Cm, dt, A, dy, dh


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()


def events_ms(fn, n: int = 10) -> float:
    for _ in range(2):
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
        raise SystemExit("ssd_bwd_check: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0}))
    for name in ("ssd_scan", "ssd_scan_bwd"):
        lines = libs[name].with_suffix(".log").read_text().splitlines()
        print(json.dumps({name: [ln.strip()[-120:] for ln in lines
                                 if "Compiling entry" in ln or "Used" in ln or "spill" in ln]}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, L, H, P, N, K in SHAPES + TRAIN:
        x, Bm, Cm, dt, A, dy, dh = inputs(gen, B, L, H, P, N)
        y, h, states = ssd._launch(x, Bm, Cm, dt, A, K, True, with_states=True)
        y0, h0 = ssd._launch(x, Bm, Cm, dt, A, K, True)
        y_plain, h_plain, states_plain = ssd_chunked(x, Bm, Cm, dt, A, chunk=K,
                                                     return_states=True, cs64=True)
        row = {"shape": [B, L, H, P, N, K],
               "y_rel_err": rel(y, y_plain), "h_rel_err": rel(h, h_plain),
               "states_rel_err": rel(states, states_plain),
               "y_vs_serving_rel_err": rel(y, y0)}
        for name, cot in (("dh", dh), ("no_dh", None)):
            g1 = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, cot, K)
            g2 = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, cot, K)
            torch.cuda.synchronize()
            ref = ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, cot, chunk=K)
            row[name] = {"bitexact": all(torch.equal(a, b) for a, b in zip(g1, g2)),
                         "rel_err": {n: rel(a, b) for n, a, b in
                                     zip(("dx", "dB", "dC", "ddt", "dA"), g1, ref)},
                         "finite": all(bool(torch.isfinite(a).all()) for a in g1)}
            del g1, g2, ref
        print(json.dumps(row), flush=True)
        del x, Bm, Cm, dt, A, dy, dh, y, h, states, y0, h0, y_plain, h_plain, states_plain
        torch.cuda.empty_cache()
    # the autograd path: one forward (training instance) and one backward launch
    x, Bm, Cm, dt, A, dy, _ = inputs(gen, 2, 128, 3, 16, 8)
    leaves = [t.clone().requires_grad_() for t in (x, Bm, Cm, dt, A)]
    before = (ssd.launches, ssd.bwd_launches)
    ssd.ssd_scan_op(*leaves, chunk=32).backward(dy)
    torch.cuda.synchronize()
    print(json.dumps({"autograd_launches": [ssd.launches - before[0],
                                            ssd.bwd_launches - before[1]],
                      "grads_finite": all(bool(torch.isfinite(t.grad).all())
                                          for t in leaves)}))
    for B, L, H, P, N, K in TRAIN:
        x, Bm, Cm, dt, A, dy, _ = inputs(gen, B, L, H, P, N)
        _, _, states = ssd._launch(x, Bm, Cm, dt, A, K, True, with_states=True)
        print(json.dumps({
            "shape": [B, L, H, P, N, K],
            "fwd_ms": events_ms(lambda: ssd._launch(x, Bm, Cm, dt, A, K, True)),
            "fwd_states_ms": events_ms(lambda: ssd._launch(x, Bm, Cm, dt, A, K, True,
                                                           with_states=True)),
            "bwd_ms": events_ms(lambda: ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, None,
                                                        K)),
            "bwd_plain_ms": events_ms(lambda: ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy,
                                                               None, chunk=K), n=2)}),
              flush=True)
        del x, Bm, Cm, dt, A, dy, states
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
