"""Time this tree's flash forward against an older tree's, in turns.

The forward kernel can write each query row's LSE for the backward; serving
passes no LSE pointer and runs kernel instances without that code, so its
time should not move. This builds ``src/repro_torch/csrc/flash_attention.cu``
of this checkout and of another (``--parent DIR``: the root of an unpacked
older tree) with the port's nvcc flags, one nvcc each, both started
together, and times both through their C entry points at ``chip_smoke.py``'s
flash shapes (CUDA-graph replay, ``chip_smoke.device_ms``) in the order
parent, change, change, parent; at the training shape also this tree's
instance that writes the LSE. An entry point with no ``lse`` argument is
recognised from its source. Prints one JSON line per shape, the registers
ptxas gave each instance, then the card's name and power limit. Needs an
NVIDIA GPU and nvcc::

    git archive <parent commit> | tar -x -C build/parent
    python tools/flash_lse_ab.py --parent build/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "flash_lse_ab"
SOURCE = Path("src/repro_torch/csrc/flash_attention.cu")
# (case, B, S, H, Kh, D, window): chip_smoke.py's flash rows, causal bf16
SHAPES = [("serving: qwen1.5-0.5b prefill", 4, 64, 16, 16, 64, None),
          ("long prompt", 1, 4096, 16, 16, 64, None),
          ("serving: deepseek-v2-lite-16b prefill, D 192", 4, 64, 16, 16, 192, None),
          ("serving: hymba-1.5b prefill, window 1024", 4, 1280, 25, 5, 64, 1024),
          ("training: rdmabox-paper-100m forward", 8, 512, 12, 4, 64, None)]


def build(sources: dict) -> dict:
    """name → (ctypes entry point, takes an lse pointer, ptxas register lines)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name} failed to build:\n{log[-3000:]}")
        with_lse = "void* out, void* lse" in sources[name].read_text()
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * (5 if with_lse else 4) + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        out[name] = (fn, with_lse,
                     [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the older tree to compare with")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("flash_lse_ab: torch sees no CUDA device")
    libs = build({"parent": args.parent / SOURCE, "change": ROOT / SOURCE})
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def call(name, q, k, v, o, lse, window):
        fn, with_lse, _ = libs[name]
        B, S, H, D = q.shape
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
        if with_lse:
            ptrs.append(None if lse is None else lse.data_ptr())
        _build.check(fn(*ptrs, B, S, S, H, k.shape[2], D, 1, window or 0, 1,
                        torch.cuda.current_stream().cuda_stream), name)

    for case, B, S, H, Kh, D, window in SHAPES:
        q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, S, Kh, D, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        outs = {n: torch.empty_like(q) for n in libs}
        ms = {n: [] for n in libs}
        for name in ("parent", "change", "change", "parent"):
            ms[name].append(cs.device_ms(lambda: call(name, q, k, v, outs[name], None, window)))
        row = {"case": case, "shape": [B, S, H, Kh, D], "window": window,
               "ms_in_turns": ms, "median_ms": {n: statistics.median(t) for n, t in ms.items()},
               "same_output": bool(torch.equal(outs["parent"], outs["change"]))}
        if case.startswith("training"):
            lse = torch.empty(B, H, S, dtype=torch.float32, device=dev)
            o = torch.empty_like(q)
            row["change_with_lse_ms"] = cs.device_ms(lambda: call("change", q, k, v, o, lse,
                                                                 window))
        print(json.dumps(row), flush=True)
    print(json.dumps({"ptxas": {n: lib[2] for n, lib in libs.items()}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
