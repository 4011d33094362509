"""Probe the FP64 tensor-core products (``mma.sync`` f64) on the card.

Before the SSD scan's training kernels were built on FP64 ``mma.sync``, this
checked what they rely on: for each shape (m8n8k4, and Hopper's m16n8k4,
m16n8k8, m16n8k16) the fragment layout the kernels assume (A row g, column
t + 4q; B row t + 4q, column g; the accumulator at (g, 2t), (g, 2t + 1),
(g + 8, 2t), (g + 8, 2t + 1), with g = lane / 4, t = lane % 4) against a
host product, and the rate of each, a CTA of 8 warps an SM-slot, in three
settings:

- ``regs``: operands already in registers as f64 (the unit's own rate);
- ``cvt``: every operand widened from f32 just before its product, as a
  warp tile of 32 x 32 with f32 operands does (16 conversions a lane for
  8 products of m16n8k8);
- ``smem``: the same with the f32 operands read from shared memory.

One JSON line a shape and setting (TFLOP/s), then the card's name and power
limit. Needs an NVIDIA GPU and nvcc::

    python tools/dmma_probe.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "dmma_probe"

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

template <int KS> struct Frag;     // K of the shape: registers a lane holds
template <> struct Frag<4> { enum { A = 2, B = 1 }; };
template <> struct Frag<8> { enum { A = 4, B = 2 }; };
template <> struct Frag<16> { enum { A = 8, B = 4 }; };

__device__ __forceinline__ void mma16n8k4(double (&d)[4], const double (&a)[2],
                                          const double (&b)[1]) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void mma16n8k8(double (&d)[4], const double (&a)[4],
                                          const double (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma16n8k16(double (&d)[4], const double (&a)[8],
                                           const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
               "{%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
                 "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
__device__ __forceinline__ void mma8n8k4(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
               "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a), "d"(b));
}

template <int KS>
__device__ __forceinline__ void mma_k(double (&d)[4], const double* a, const double* b) {
  if constexpr (KS == 4) {
    const double aa[2] = {a[0], a[1]}, bb[1] = {b[0]};
    mma16n8k4(d, aa, bb);
  } else if constexpr (KS == 8) {
    const double aa[4] = {a[0], a[1], a[2], a[3]}, bb[2] = {b[0], b[1]};
    mma16n8k8(d, aa, bb);
  } else {
    const double aa[8] = {a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]};
    const double bb[4] = {b[0], b[1], b[2], b[3]};
    mma16n8k16(d, aa, bb);
  }
}

// one warp: D (16 x 8) = A (16 x KS) . B (KS x 8), A, B, D row-major in device memory;
// ks 0 runs m8n8k4 (D 8 x 8, A 8 x 4)
extern "C" __global__ void layout_kernel(const double* A, const double* B, double* D, int ks) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  if (ks == 0) {
    double d[2] = {0.0, 0.0};
    mma8n8k4(d, A[g * 4 + t], B[t * 8 + g]);
    D[g * 8 + 2 * t] = d[0];
    D[g * 8 + 2 * t + 1] = d[1];
    return;
  }
  double a[8], b[4], d[4] = {0.0, 0.0, 0.0, 0.0};
  for (int q = 0; q < ks / 4; ++q) {
    a[2 * q] = A[g * ks + t + 4 * q];
    a[2 * q + 1] = A[(g + 8) * ks + t + 4 * q];
    b[q] = B[(t + 4 * q) * 8 + g];
  }
  if (ks == 4) mma_k<4>(d, a, b);
  if (ks == 8) mma_k<8>(d, a, b);
  if (ks == 16) mma_k<16>(d, a, b);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

// rate: each warp runs `iters` k steps of a 32 x 32 warp tile (2 x 4 accumulator
// tiles of 16 x 8, 8 products of m16n8kKS a step). mode 0: f64 operands in
// registers; 1: f32 operands widened before each step; 2: f32 operands read
// from shared memory and widened
template <int KS>
__global__ void __launch_bounds__(256) rate_kernel(const float* seed, double* out, int iters,
                                                  int mode) {
  __shared__ float tile[64 * 68];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < 64 * 68; e += 256) tile[e] = seed[e & 255];
  __syncthreads();
  double acc[2][4][4] = {};
  double a[2][8], b[4][4];
  float af[2][8], bf[4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      af[m][r] = seed[(lane + 7 * m + r) & 255];
      a[m][r] = af[m][r];
    }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      bf[n][r] = seed[(lane + 11 * n + 3 * r) & 255];
      b[n][r] = bf[n][r];
    }
  const int g = lane >> 2, t = lane & 3;
  for (int it = 0; it < iters; ++it) {
    if (mode == 1) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int r = 0; r < Frag<KS>::A; ++r) {
          af[m][r] = af[m][r] * 1.0000001f;
          a[m][r] = af[m][r];
        }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < Frag<KS>::B; ++r) {
          bf[n][r] = bf[n][r] * 1.0000001f;
          b[n][r] = bf[n][r];
        }
    } else if (mode == 2) {
      const int k0 = (it * KS) & 63;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int r = 0; r < Frag<KS>::A; ++r)
          a[m][r] = tile[(16 * m + g + 8 * (r & 1)) * 68 + ((k0 + t + 4 * (r >> 1)) & 63)];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < Frag<KS>::B; ++r)
          b[n][r] = tile[((k0 + t + 4 * r) & 63) * 68 + 8 * n + g + 32 * (warp & 1)];
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_k<KS>(acc[m][n], a[m], b[n]);
  }
  double s = 0.0;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s += acc[m][n][r];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int probe_layout(const double* A, const double* B, double* D, int ks) {
  layout_kernel<<<1, 32>>>(A, B, D, ks);
  return static_cast<int>(cudaDeviceSynchronize());
}

// milliseconds of one launch of `blocks` CTAs
extern "C" float probe_rate(const float* seed, double* out, int blocks, int iters, int mode,
                            int ks) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (ks == 4) rate_kernel<4><<<blocks, 256>>>(seed, out, iters, mode);
    if (ks == 8) rate_kernel<8><<<blocks, 256>>>(seed, out, iters, mode);
    if (ks == 16) rate_kernel<16><<<blocks, 256>>>(seed, out, iters, mode);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dmma_probe: torch sees no CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "dmma_probe.cu", OUT / "libdmma_probe.so"
    src.write_text(SOURCE)
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    print(json.dumps({"ptxas": [ln.strip()[-110:] for ln in
                                (log.stdout + log.stderr).splitlines()
                                if "Used" in ln or "spill" in ln or "error" in ln]}))
    if log.returncode:
        raise SystemExit("dmma_probe: nvcc failed")
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_layout.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.probe_rate.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    lib.probe_rate.restype = ctypes.c_float
    rng = np.random.default_rng(0)
    for ks in (0, 4, 8, 16):
        m, k = (8, 4) if ks == 0 else (16, ks)
        A = rng.normal(size=(m, k)).astype(np.float32).astype(np.float64)
        B = rng.normal(size=(k, 8)).astype(np.float32).astype(np.float64)
        tA, tB = torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()
        tD = torch.zeros(m, 8, dtype=torch.float64, device="cuda")
        rc = lib.probe_layout(tA.data_ptr(), tB.data_ptr(), tD.data_ptr(), ks)
        err = float(np.abs(tD.cpu().numpy() - A @ B).max()) if rc == 0 else None
        print(json.dumps({"shape": f"m{m}n8k{k}", "rc": rc, "layout_max_abs_err": err}),
              flush=True)
    seed = torch.from_numpy(rng.normal(size=256).astype(np.float32)).cuda()
    blocks, iters = 132 * 4, 4096
    out = torch.empty(blocks * 256, dtype=torch.float64, device="cuda")
    for ks in (4, 8, 16):
        for mode, name in enumerate(("regs", "cvt", "smem")):
            ms = lib.probe_rate(seed.data_ptr(), out.data_ptr(), blocks, iters, mode, ks)
            flops = 2.0 * blocks * 8 * iters * 8 * 16 * 8 * ks
            print(json.dumps({"shape": f"m16n8k{ks}", "setting": name, "ms": ms,
                              "tflops": flops / ms / 1e9 if ms > 0 else None}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
