"""Time variants of the port's CUDA kernels, to see where their time goes.

Each variant is a kernel source with a few lines replaced: a product loop
cut out, the exp removed, another slice width. Every variant is compiled
with the port's nvcc flags into ``build/kernel_variants/``, one ``nvcc``
each, all started together, and timed through its C entry point at a
serving shape like ``chip_smoke.py``'s ``kernels`` line (median of CUDA-graph
replays). A variant that cuts work computes a wrong result: only its time
means anything. Needs an NVIDIA GPU and nvcc; prints one JSON line per
variant, then the card's name and power limit::

    python tools/kernel_variants.py            # build and time every variant
    python tools/kernel_variants.py paged      # only one kernel's (ssd_scan, flash,
                                               # flash_bwd, paged, ring, latent)
    python tools/kernel_variants.py --check    # only apply the edits (no GPU)
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "kernel_variants"

# (old, new) edits of csrc/ssd_scan.cu; timed at mamba2-780m's prefill shape
SSD = {
    "shipped": [],
    "no_intra": [("for (int kt = 0; kt <= last; ++kt) {", "for (int kt = 0; kt < 0; ++kt) {")],
    "no_inbound": [("      for (int n0 = 0; n0 < N; n0 += 8) {",
                    "      for (int n0 = 0; n0 < 0; n0 += 8) {")],
    "no_state": [("for (int kt = 0; kt < nK8; ++kt) {", "for (int kt = 0; kt < 0; ++kt) {")],
    "one_tf32": [("for (int nt = 0; nt < kNT; ++nt) mma_tf32(d[nt], a.lo, b[nt].hi);", ""),
                 ("for (int nt = 0; nt < kNT; ++nt) mma_tf32(d[nt], a.hi, b[nt].lo);", "")],
    "no_exp": [("* expf(cs_", "* (cs_")],
    "cb_only": [("  extern __shared__ float4 smem4[];",
                 "  if (L > 0) return;\n  extern __shared__ float4 smem4[];")],
    "p_slice_32": [("constexpr int kPSlice = 64;", "constexpr int kPSlice = 32;"),
                   ("__launch_bounds__(kThreads)\nssd_scan_kernel",
                    "__launch_bounds__(kThreads, 2)\nssd_scan_kernel")],
    "p_slice_16": [("constexpr int kPSlice = 64;", "constexpr int kPSlice = 16;"),
                   ("__launch_bounds__(kThreads)\nssd_scan_kernel",
                    "__launch_bounds__(kThreads, 2)\nssd_scan_kernel")],
}
# (old, new) edits of csrc/flash_attention.cu; timed at FLASH_CASES (causal)
FLASH = {
    "shipped": [],
    "no_exp": [("fast_exp2(s[n][2 * rr] - mn)", "(s[n][2 * rr] - mn)"),
               ("fast_exp2(s[n][2 * rr + 1] - mn)", "(s[n][2 * rr + 1] - mn)")],
    "no_pv": [("          mma_bf16(o[2 * dp], pa, r[0], r[1]);\n"
               "          mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);\n", "")],
    "no_s": [("          mma_bf16(s[2 * np], qf[kk], r[0], r[1]);\n"
              "          mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);\n", "")],
    "exp2f": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = exp2f(x);")],
}
# (case, B, S, H, D) of the flash timings: every variant at each
FLASH_CASES = [("long prompt D 64", 1, 4096, 16, 64),
               ("deepseek prefill D 192", 4, 64, 16, 192),
               ("long prompt D 192", 1, 4096, 16, 192)]

# (old, new) edits of csrc/flash_attention_bwd.cu; timed in bf16 at the
# training shape (rdmabox-paper-100m: B 8, S 512, H 12, Kh 4, D 64, causal).
# A kernel cut to an early return still launches.
BWD_DQ = "  using C = Tc<D>;\n  constexpr int kThreadsQ = 32 * kTcWarps;\n"
BWD_DKDV = ("  using C = Tc<D>;\n  constexpr int kS = tc_stride<D>();\n"
            "  constexpr int kDK = D / 16;                    // k steps of S^T and dP^T\n")
FLASH_BWD = {
    "shipped": [],
    "no_dq": [(BWD_DQ, "  if (Sq > 0) return;\n" + BWD_DQ)],
    "no_dkdv": [(BWD_DKDV, "  if (Sq > 0) return;\n" + BWD_DKDV)],
    "delta_only": [(BWD_DQ, "  if (Sq > 0) return;\n" + BWD_DQ),
                   (BWD_DKDV, "  if (Sq > 0) return;\n" + BWD_DKDV)],
    "no_exp": [("fast_exp2(fmaf(", "(fmaf(")],
    "no_dvdk_mma": [("          mma_bf16(acc_v[2 * dp], pa4, r[0], r[1]);\n"
                     "          mma_bf16(acc_v[2 * dp + 1], pa4, r[2], r[3]);\n", ""),
                    ("          mma_bf16(acc_k[2 * dp], sa4, r[0], r[1]);\n"
                     "          mma_bf16(acc_k[2 * dp + 1], sa4, r[2], r[3]);\n", "")],
    "no_dq_mma": [("          mma_bf16(acc[2 * dn], sa4, r[0], r[1]);\n"
                   "          mma_bf16(acc[2 * dn + 1], sa4, r[2], r[3]);\n", "")],
    "dq_chunk_64": [("static constexpr int kChunkK = D >= 64 ? 32 : 64;",
                     "static constexpr int kChunkK = 64;")],
    "walk_1": [("static constexpr int kWalk = 2 / kSplit;", "static constexpr int kWalk = 1;")],
}

# (old, new) edits of csrc/paged_attention.cu; timed at chip_smoke.py's long
# decode context (8192 tokens a sequence) planned at R = 4 and R = 1, each at
# the wrapper's launch shape; the shipped source also at other launch shapes
# and stage sizes (call arguments, no edit)
NO_COMPUTE = [("for (int base = slice * RW; base < n;", "for (int base = slice * RW; base < 0;")]
STAGES = "constexpr int kStages = 2;"
PAGED = {
    "shipped": [],
    "no_compute": NO_COMPUTE,
    "l2_none": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B", "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    "stages_3": [(STAGES, "constexpr int kStages = 3;")],
    "stages_4": [(STAGES, "constexpr int kStages = 4;")],
    "stages_4_no_compute": NO_COMPUTE + [(STAGES, "constexpr int kStages = 4;")],
    "batch_2": [("constexpr int kBatch = 4;", "constexpr int kBatch = 2;")],
}

# (old, new) edits of csrc/ring_attention.cu; timed at hymba-1.5b.decode's ring
# (B 64, 1024 slots, H 25, Kh 5, D 64) at several split counts
RING_STAGES = "constexpr int kStages = 3;"
RING = {
    "shipped": [],
    "no_compute": [("    for (int t = 0; t < kTilesPerWarp; ++t) {",
                    "    for (int t = 0; t < 0; ++t) {")],
    "no_pv": [("      for (int i = 0; i < 16 / RW; ++i) {", "      for (int i = 0; i < 0; ++i) {")],
    "stages_2": [(RING_STAGES, "constexpr int kStages = 2;")],
    "stages_4": [(RING_STAGES, "constexpr int kStages = 4;")],
    "l2_256": [('"cp.async.cg.shared.global [%0]', '"cp.async.cg.shared.global.L2::256B [%0]')],
}

# (old, new) edits of csrc/latent_attention.cu; timed at deepseek-v2-lite-16b.decode's
# latent cache (B 64, 2,560 slots, lengths 1 to 2,560) at several split counts.
# q_hi_only and p_hi_only keep one bf16 term of q_lat or of P (the precision
# faults the f32 decode must not have): their error against the f64 oracle is
# printed beside every variant's
LATENT_SHAPE = "constexpr int kT = 32, kStages = 2;"
SCORE_TERMS = "        for (int i = 0; i < 3; ++i) {\n          mma_bf16(s[2 * np]"
PV_TERMS = "        for (int i = 0; i < 3; ++i) {\n          mma_bf16(acc[2 * dp]"
LATENT = {
    "shipped": [],
    "stages_3": [(LATENT_SHAPE, "constexpr int kT = 32, kStages = 3;")],
    "t_64": [(LATENT_SHAPE, "constexpr int kT = 64, kStages = 2;")],
    "no_compute": [("    for (int ks = 0; ks < KS; ++ks) {",
                    "    for (int ks = 0; ks < 0; ++ks) {"),
                   ("      for (int dp = 0; dp < CW / 16; ++dp) {",
                    "      for (int dp = 0; dp < 0; ++dp) {")],
    "two_ctas": [("__launch_bounds__(Shape<R, DR, CW, T, STAGES>::kThreads)",
                  "__launch_bounds__(Shape<R, DR, CW, T, STAGES>::kThreads, 2)")],
    "no_reduce": [("      for (int w = 1; w < NW; ++w) {", "      for (int w = 1; w < 1; ++w) {")],
    "q_hi_only": [(SCORE_TERMS, SCORE_TERMS.replace("i < 3", "i < 1"))],
    "p_hi_only": [(PV_TERMS, PV_TERMS.replace("i < 3", "i < 1"))],
}


def write_variants(kind: str, variants: dict) -> dict:
    """Apply each variant's edits to csrc/<kind>.cu; returns name → source path."""
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in variants.items():
        src = (_build.CSRC / f"{kind}.cu").read_text()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{kind} variant {name}: edit target not found: {old!r}")
            src = src.replace(old, new)
        paths[name] = OUT / f"{kind}_{name}.cu"
        paths[name].write_text(src)
    return paths


def build(paths: dict) -> dict:
    """nvcc each source in parallel; returns name → (library, ptxas lines)."""
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, cu in paths.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log[-3000:]}")
        libs[name] = (paths[name].with_suffix(".so"),
                      [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "Used" in ln or "spill stores" in ln and not ln.strip().startswith("0 ")])
    return libs


def main() -> None:
    kinds = {"ssd_scan": SSD, "flash": FLASH, "flash_bwd": FLASH_BWD, "paged": PAGED,
             "ring": RING, "latent": LATENT}
    only = [a for a in sys.argv[1:] if a in kinds] or list(kinds)
    files = {"flash": "flash_attention", "flash_bwd": "flash_attention_bwd",
             "paged": "paged_attention", "ring": "ring_attention",
             "latent": "latent_attention"}
    sources = {k: write_variants(files.get(k, k), kinds[k]) for k in only}
    if "--check" in sys.argv:
        print(json.dumps({"variants": sorted(f"{k}/{v}" for k in sources for v in sources[k])}))
        return
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: torch sees no CUDA device")
    libs = {k: build(src) for k, src in sources.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if "ssd_scan" in libs:
        time_ssd(cs, libs["ssd_scan"], dev, gen, stream)
    if "flash" in libs:
        time_flash(cs, libs["flash"], dev, gen, stream)
    if "flash_bwd" in libs:
        time_flash_bwd(cs, libs["flash_bwd"], dev, gen, stream)
    if "paged" in libs:
        time_paged(cs, libs["paged"], dev, gen, stream)
    if "ring" in libs:
        time_ring(cs, libs["ring"], dev, gen, stream)
    if "latent" in libs:
        time_latent(cs, libs["latent"], dev, gen, stream)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


def time_ssd(cs, ssd_libs, dev, gen, stream) -> None:
    import torch

    B, L, H, P, N, K = cs.ssd_serving_shape()
    x, Bm, Cm, dt, A = cs.ssd_inputs(dev, gen, B, L, H, P, N, model_like=True)
    y, h = torch.empty_like(x), torch.empty(B, H, N, P, device=dev)
    k16 = -(-K // 16) * 16
    scratch = torch.empty(B * (L // K) * k16 * k16, device=dev)
    for name, (so, used) in ssd_libs.items():
        fn = ctypes.CDLL(str(so)).ssd_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

        def call():
            _build.check(fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                            A.data_ptr(), y.data_ptr(), h.data_ptr(), scratch.data_ptr(),
                            B, L, H, P, N, K, stream()), name)
        print(json.dumps({"kernel": "ssd_scan", "variant": name, "ms": cs.device_ms(call),
                          "ptxas": used}), flush=True)


def time_flash(cs, flash_libs, dev, gen, stream) -> None:
    import torch
    fns = {}
    for name, (so, used) in flash_libs.items():
        fns[name] = ctypes.CDLL(str(so)).flash_attention_fwd
        fns[name].argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    for case, Bf, S, Hf, D in FLASH_CASES:
        q, k, v = (torch.randn(Bf, S, Hf, D, generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        o = torch.empty_like(q)
        for name, fn in fns.items():
            def call():
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                None, Bf, S, S, Hf, Hf, D, 1, 0, 1, stream()), name)
            print(json.dumps({"kernel": "flash_attention", "variant": name, "case": case,
                              "ms": cs.device_ms(call), "ptxas": flash_libs[name][1]}),
                  flush=True)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        print(json.dumps({"kernel": "scaled_dot_product_attention", "case": case,
                          "ms": cs.device_ms(lambda: torch.nn.functional
                                             .scaled_dot_product_attention(
                                                 qt, kt, vt, is_causal=True))}))


def time_flash_bwd(cs, bwd_libs, dev, gen, stream) -> None:
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    B, S, H, Kh, D = 8, 512, 12, 4, 64
    q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Kh, D, generator=gen, device=dev).bfloat16() for _ in range(2))
    o, lse = fa._launch(q, k, v, True, None, with_lse=True)
    delta = torch.empty(B, H, S, dtype=torch.float32, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for name, (so, used) in bwd_libs.items():
        fn = ctypes.CDLL(str(so)).flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

        def call():
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), B, S, S, H, Kh, D, 1, 0, 1,
                            stream()), name)
        print(json.dumps({"kernel": "flash_attention_bwd", "variant": name,
                          "case": "training shape", "ms": cs.device_ms(call),
                          "ptxas": used}), flush=True)


def time_paged(cs, paged_libs, dev, gen, stream) -> None:
    from repro_torch.kernels.paged_attention import ops as pa
    import torch
    q, kv, lengths, plans = cs.paged_long_inputs(dev, gen)
    B, H, D = q.shape
    P, T, _, Kh, _ = kv.shape
    row = 2 * D * q.element_size()                # K and V of one head, one token
    sms = pa.sm_count(dev)
    out = torch.empty_like(q)
    partial = torch.empty(B * Kh * 64 * (H // Kh) * (D + 2), device=dev)
    for name, (so, used) in paged_libs.items():
        fn = ctypes.CDLL(str(so)).paged_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        for R, (starts, valid, live) in plans.items():
            heads, S = pa.launch_shape(B, Kh, live, sms, R * T * row)
            shapes = [(heads, S, pa.box_tokens(R * T, heads * row))]
            if name == "shipped":               # (heads a CTA, splits, tokens a stage)
                shapes += ([(1, 4, 64), (1, 8, 64), (1, 5, 32), (1, 5, 16), (2, 9, 32),
                            (4, 17, 16)] if R == 4 else [(1, 5, 16), (2, 9, 16)])
            for heads, S, box in shapes:
                def call():
                    _build.check(fn(q.data_ptr(), kv.data_ptr(), starts.data_ptr(),
                                    valid.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                                    partial.data_ptr(), B, H, Kh, D, T, P, starts.shape[1],
                                    box, live, heads, S, 1, stream()), name)
                print(json.dumps({"kernel": "paged_attention", "variant": name, "R": R,
                                  "heads_per_cta": heads, "splits": S, "box_tokens": box,
                                  "ms": cs.device_ms(call), "ptxas": used[:1]}), flush=True)


def time_ring(cs, ring_libs, dev, gen, stream) -> None:
    """Every variant at hymba-1.5b.decode's ring (B 64) at 1, 2 and 4 splits;
    the shipped source also at B 1, 4 and 16 over the same 1024 slots at 1 to
    16 splits, where the wrapper's split count is decided."""
    from repro_torch.kernels.ring_attention import ops as ra
    import numpy as np
    import torch
    H, Kh, D, length = 25, 5, 64, 1024
    sizes = {B: cs.ring_inputs(dev, gen, B, H, Kh, D, length, np.full(B, 2047))
             for B in (64, 16, 4, 1)}
    partial = torch.empty(64 * Kh * 16 * (H // Kh) * (D + 2), device=dev)
    for name, (so, _) in ring_libs.items():
        fn = ctypes.CDLL(str(so)).ring_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        for B, (q, k, v, valid) in sizes.items():
            if B != 64 and name != "shipped":
                continue
            out = torch.empty_like(q)
            for S in (1, 2, 4) if B == 64 else (1, 2, 4, 8, 16):
                def call():
                    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                                    out.data_ptr(), partial.data_ptr(), B, H, Kh, D, length, S,
                                    0, D ** -0.5, stream()), name)
                print(json.dumps({"kernel": "ring_attention", "variant": name, "B": B,
                                  "splits": S, "wrapper_splits": ra.split_count(
                                      B * Kh, length, ra.sm_count(dev)),
                                  "ms": cs.device_ms(call)}), flush=True)



def time_latent(cs, latent_libs, dev, gen, stream) -> None:
    """Every variant at deepseek-v2-lite-16b.decode's latent cache at 2, 3, 4
    and 6 splits (the shipped source at 1 to 10), with its o_lat's error
    against the f64 oracle at the wrapper's split count: once at lengths 1 to
    2,560 (``chip_smoke.latent_cell_lengths``), once at the cell's traffic's
    (histories 1,024-2,048 and a turn of up to 256 so far)."""
    import numpy as np
    from repro_torch.configs import get_config
    cfg = get_config(cs.MLA_ARCH)
    B, length = cs.LATENT_DECODE
    traffic = np.random.default_rng(1).integers(1024, 2048 + 256 + 1, B)
    for lengths_from, inputs in (
            ("1-2560", cs.latent_decode_inputs(dev, gen)),
            ("1024-2304", cs.latent_inputs(dev, gen, B, cfg.num_heads, cfg.kv_lora_rank,
                                           cfg.qk_rope_dim, length, traffic))):
        time_latent_at(cs, latent_libs, stream, lengths_from, *inputs)


def time_latent_at(cs, latent_libs, stream, lengths_from, q_lat, q_pe, c_kv, k_pe, valid,
                   lengths) -> None:
    from repro_torch.kernels.latent_attention import ops as la
    import torch
    dev = q_lat.device
    B, H, R = q_lat.shape
    length, dr = c_kv.shape[1], k_pe.shape[-1]
    scale = cs.latent_scale()
    picked = la.split_count(B, length, la.sm_count(dev))
    out = torch.empty_like(q_lat)
    partial = torch.empty(B * H * 10 * (R + 2), device=dev)
    bound = cs.bound_ms(*cs.latent_work(q_lat, q_pe, c_kv, k_pe, valid, lengths),
                        torch.bfloat16)[0]
    for name, (so, used) in latent_libs.items():
        fn = ctypes.CDLL(str(so)).latent_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                     ctypes.c_void_p]

        def call(S):
            _build.check(fn(q_lat.data_ptr(), q_pe.data_ptr(), c_kv.data_ptr(),
                            k_pe.data_ptr(), valid.data_ptr(), out.data_ptr(),
                            partial.data_ptr(), B, H, R, dr, length, S, 0, scale, stream()),
                         name)
        call(picked)
        torch.cuda.synchronize()
        err = cs.latent_errors(out.clone(), q_lat, q_pe, c_kv, k_pe, valid, lengths,
                               scale)["kernel"]
        for S in range(1, 11) if name == "shipped" else (2, 3, 4, 6):
            print(json.dumps({"kernel": "latent_attention", "variant": name, "splits": S,
                              "lengths": lengths_from, "live_slots": int(lengths.sum()),
                              "wrapper_splits": picked, "ms": cs.device_ms(lambda: call(S)),
                              "bound_ms": bound, "max_rel_err": err, "ptxas": used}),
                  flush=True)


if __name__ == "__main__":
    main()
