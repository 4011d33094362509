"""Time this tree's SSD-scan training kernels against an older tree's, in turns.

Builds ``src/repro_torch/csrc/ssd_scan.cu`` and ``ssd_scan_bwd.cu`` of this
checkout and of another (``--parent DIR``: the root of an unpacked older
tree) with the port's nvcc flags, one nvcc each, all started together, and
times both trees' training forward (``ssd_scan_fwd_states``) and backward
(``ssd_scan_bwd``, from this tree's states, no h_final cotangent) through
their C entry points (CUDA-graph replay, ``chip_smoke.device_ms``) in the
order parent, change, change, parent, at mamba2-780m's training shape and
hymba-1.5b's N 16. Each case also prints whether the two trees' y are equal
in every bit (they are when both share the state sweep and sum y's products
in the same order), both trees' largest error against
the plain versions (max|a − b| / max(|b|, 1)), then this tree's device time
by kernel over a few calls (torch.profiler). Last, the registers and spills
ptxas reports for every kernel of both trees, and the card's name and power
limit. Needs an NVIDIA GPU and nvcc::

    git archive <parent commit> | tar -x -C build/parent
    python tools/ssd_bwd_ab.py --parent build/parent
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

OUT = ROOT / "build" / "ssd_bwd_ab"
CSRC = Path("src/repro_torch/csrc")
SHAPES = [("training: mamba2-780m", 8, 512, 48, 64, 128, 256),   # B, L, H, P, N, chunk
          ("train_grads: hymba-1.5b, N 16", 4, 512, 50, 64, 16, 256)]


def ptxas_report(log: str) -> list:
    """[kernel, registers, spill stores, spill loads] for each kernel in an
    ``nvcc -Xptxas -v`` log."""
    rows, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            found = re.findall(r"\d+([a-z_0-9]+_kernel)", entry.group(1))
            name = found[-1] if found else entry.group(1)
            spill = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            rows.append([name, int(used.group(1)), *(spill or (None, None))])
            name = None
    return rows


def build(trees: dict) -> dict:
    """tree → {"fwd": entry, "bwd": entry, "scratch": entry, "ptxas": report}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tree, root in trees.items():
        for src in ("ssd_scan", "ssd_scan_bwd"):
            so = OUT / f"{tree}_{src}.so"
            procs[tree, src] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(root / CSRC / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {t: {"ptxas": []} for t in trees}
    for (tree, src), (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{tree} {src} failed to build:\n{log[-3000:]}")
        out[tree]["ptxas"] += [[src, *r] for r in ptxas_report(log)]
        lib = ctypes.CDLL(str(so))
        if src == "ssd_scan":
            fn = lib.ssd_scan_fwd_states
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out[tree]["fwd"] = fn
        else:
            fn = lib.ssd_scan_bwd
            fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out[tree]["bwd"] = fn
            lib.ssd_scan_bwd_scratch_floats.argtypes = [ctypes.c_int] * 6
            lib.ssd_scan_bwd_scratch_floats.restype = ctypes.c_longlong
            out[tree]["scratch"] = lib.ssd_scan_bwd_scratch_floats
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the older tree to compare with")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_bwd_ref
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_ab: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build({"parent": args.parent, "change": ROOT})
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)

    def rel(a, b) -> float:
        return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()

    for case, B, L, H, P, N, K in SHAPES:
        x, Bm, Cm, dt, A = cs.ssd_inputs(dev, gen, B, L, H, P, N, model_like=True)
        dy = torch.randn(B, L, H, P, generator=gen, device=dev)
        nC = L // K
        _, _, states = ssd._launch(x, Bm, Cm, dt, A, K, True, with_states=True)
        outs = {}
        for tree, lib in libs.items():
            y, h = torch.empty_like(x), torch.empty(B, H, N, P, device=dev)
            st = torch.empty(B, nC, H, N, P, device=dev)
            cb = torch.empty(B * nC * K * K, device=dev)
            grads = (torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm),
                     torch.empty_like(dt), torch.empty_like(A))
            scratch = torch.empty(lib["scratch"](B, L, H, P, N, K), device=dev)
            outs[tree] = (y, h, st, cb, grads, scratch)

        def fwd(tree):
            y, h, st, cb, _, _ = outs[tree]
            _build.check(libs[tree]["fwd"](
                x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), A.data_ptr(),
                y.data_ptr(), h.data_ptr(), cb.data_ptr(), st.data_ptr(), B, L, H, P, N, K,
                torch.cuda.current_stream().cuda_stream), tree)

        def bwd(tree):
            g, scratch = outs[tree][4], outs[tree][5]
            _build.check(libs[tree]["bwd"](
                x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), A.data_ptr(),
                states.data_ptr(), dy.data_ptr(), None, *(t.data_ptr() for t in g),
                scratch.data_ptr(), B, L, H, P, N, K, torch.cuda.current_stream().cuda_stream),
                tree)

        ms = {f"{w}_{t}": [] for w in ("fwd", "bwd") for t in libs}
        for tree in ("parent", "change", "change", "parent"):
            ms[f"fwd_{tree}"].append(cs.device_ms(lambda: fwd(tree)))
            ms[f"bwd_{tree}"].append(cs.device_ms(lambda: bwd(tree)))
        torch.cuda.synchronize()
        y_p, h_p, st_p = ssd_chunked(x, Bm, Cm, dt, A, chunk=K, return_states=True, cs64=True)
        plain = ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, None, chunk=K)
        err = {t: {"y": rel(o[0], y_p), "h_final": rel(o[1], h_p), "states": rel(o[2], st_p),
                   **{n: rel(g, p) for n, g, p in zip(("dx", "dB", "dC", "ddt", "dA"), o[4],
                                                      plain)}}
               for t, o in outs.items()}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fwd("change")
                bwd("change")
            torch.cuda.synchronize()
        by_kernel = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            if us > 0:
                name = re.findall(r"([a-z_0-9]+_kernel)", ev.key)
                by_kernel[name[-1] if name else ev.key] = us / 5 / 1e3
        y_equal = torch.equal(outs["parent"][0], outs["change"][0])
        print(json.dumps({"case": case, "shape": [B, L, H, P, N, K], "ms_in_turns": ms,
                          "y_bits_equal_to_parent": y_equal,
                          "median_ms": {n: statistics.median(t) for n, t in ms.items()},
                          "rel_err_vs_plain": err,
                          "change_ms_a_call_by_kernel": by_kernel}), flush=True)
        del x, Bm, Cm, dt, A, dy, states, outs, plain, y_p, h_p, st_p
        torch.cuda.empty_cache()
    print(json.dumps({"ptxas [source, kernel, registers, spill stores, spill loads]":
                      {t: lib["ptxas"] for t, lib in libs.items()}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
