"""Time this tree's flash backward against an older tree's, in turns.

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` of this checkout and
of another (``--parent DIR``: the root of an unpacked older tree) with the
port's nvcc flags, one nvcc each, both started together, and times both
through their C entry point ``flash_attention_bwd`` (CUDA-graph replay,
``chip_smoke.device_ms``) in the order parent, change, change, parent, in
bf16 at the training shape, qwen1.5-0.5b's ``train_grads`` shape, hymba's
window and head dim 192; the forward and its LSE come from this tree's
kernel. Each case also prints both trees' largest difference from the plain
backward (``flash_attention_bwd_ref``). Prints one JSON line per case, then
the registers and spills ptxas reports for every kernel instance of both
trees, then the card's name and power limit. Needs an NVIDIA GPU and nvcc::

    git archive <parent commit> | tar -x -C build/parent
    python tools/flash_bwd_ab.py --parent build/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "flash_bwd_ab"
SOURCE = Path("src/repro_torch/csrc/flash_attention_bwd.cu")
# (case, B, S, H, Kh, D, window): causal bf16
SHAPES = [("training: rdmabox-paper-100m", 8, 512, 12, 4, 64, None),
          ("train_grads: qwen1.5-0.5b, H = Kh = 16", 4, 512, 16, 16, 64, None),
          ("hymba-1.5b's window 1024", 1, 1280, 25, 5, 64, 1024),
          ("head dim 192 (deepseek-v2-lite-16b's MLA)", 4, 512, 16, 16, 192, None)]


def ptxas_report(log: str) -> list:
    """[kernel, dtype, head dim, registers, spill stores, spill loads] for
    each kernel instance in an ``nvcc -Xptxas -v`` log."""
    rows, row = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            kernel = re.search(r"flash_bwd_\w+?_kernel", mangled)
            dim = re.search(r"Li(\d+)E", mangled)
            row = [kernel.group(0) if kernel else mangled,
                   "bf16" if "nv_bfloat16" in mangled else "f32",
                   int(dim.group(1)) if dim else None]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and row:
            row += [None, int(spill.group(1)), int(spill.group(2))]
        used = re.search(r"Used (\d+) registers", line)
        if used and row and len(row) == 6:
            row[3] = int(used.group(1))
            rows.append(row)
            row = None
    return rows


def build(sources: dict) -> dict:
    """name → (ctypes entry point, ptxas report)."""
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
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[name] = (fn, ptxas_report(log))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the older tree to compare with")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_ab: torch sees no CUDA device")
    libs = build({"parent": args.parent / SOURCE, "change": ROOT / SOURCE})
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    for case, B, S, H, Kh, D, window in SHAPES:
        q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(B, S, Kh, D, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        o, lse = fa._launch(q, k, v, True, window, with_lse=True)
        delta = torch.empty(B, H, S, dtype=torch.float32, device=dev)
        grads = {n: (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
                 for n in libs}

        def call(name):
            dq, dk, dv = grads[name]
            _build.check(libs[name][0](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, S, S, H, Kh, D, 1, window or 0, 1,
                torch.cuda.current_stream().cuda_stream), name)

        ms = {n: [] for n in libs}
        for name in ("parent", "change", "change", "parent"):
            ms[name].append(cs.device_ms(lambda: call(name)))
        torch.cuda.synchronize()
        plain = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=window)
        err = {n: max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(grads[n], plain)) for n in libs}
        print(json.dumps({"case": case, "shape": [B, S, H, Kh, D], "window": window,
                          "ms_in_turns": ms,
                          "median_ms": {n: statistics.median(t) for n, t in ms.items()},
                          "max_abs_err_vs_plain": err}), flush=True)
        del q, k, v, do, o, lse, delta, grads, plain
        torch.cuda.empty_cache()
    print(json.dumps({"ptxas [kernel, dtype, D, registers, spill stores, spill loads]":
                      {n: lib[1] for n, lib in libs.items()}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
