// Pieces shared by the SSD scan's training forward (ssd_scan.cu,
// ssd_scan_fwd_states) and its backward (ssd_scan_bwd.cu): sizes, the FP64
// tensor-core product of a warp's tile, cp.async staging, a deterministic
// block scan and the chunk's cs summed in f64. Every function is static, so
// each library that includes this has its own copy.
//
// Arithmetic (the backward's products and the forward's state sweep; the
// forward's y stays f32 in the plain version's order, see ssd_scan.cu).
// Every product is mma.sync.m16n8k8 with f64 operands and f64
// accumulators on Hopper's FP64 tensor cores. Operands are staged in shared
// memory as f32, in their natural [token][feature] layout, and widened to f64
// as their fragments are loaded: a product of two f32 values is exact in f64
// and every sum is an IEEE f64 sum, so each product is more accurate than an
// f32 FMA on the CUDA cores. A 3xTF32 split is not (about 22 bits a product,
// truncating tensor-core sums): serving's 3xTF32 forward under training puts
// full-width mamba2-780m's f32 gradients 1.3e-3 off the plain path, past
// their 1e-4. On an NVIDIA H100 80GB HBM3 (700 W) this product runs at 61-65
// TFLOP/s of the card's 67, with f32 operands read from shared memory and
// widened (the conversions overlap the tensor cores; tools/dmma_probe.py).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ssd_f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;                           // tokens a row or column block
constexpr int kSw = 32;                          // tokens a block of the state sweeps
constexpr int kPh = 32;                          // state columns (of P) a sweep CTA owns
constexpr int kMaxChunk = 256, kMaxN = 128, kMaxP = 64;
constexpr int kS32 = 36, kS64 = 68, kS128 = 132; // shared row strides (floats): 16-byte
                                                 // aligned, == 4 mod 32 (fragment reads
                                                 // along a row are free of conflicts)
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMaxChunk <= kThreads, "the chunk scans give one token per thread");
static_assert(kMaxN <= 16 * kWarps, "a sweep warp owns one 16-row m-tile of the state");

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// d (16 x 8) += a (16 x 8) . b (8 x 8), f64, on the FP64 tensor cores. Lane
// (g = lane / 4, t = lane % 4) holds a[g][t], a[g + 8][t], a[g][t + 4],
// a[g + 8][t + 4]; b[t][g], b[t + 4][g]; d[g][2t], d[g][2t + 1], d[g + 8][2t],
// d[g + 8][2t + 1] (checked on the card by tools/dmma_probe.py).
static __device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                            const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

enum { kNoScale = 0, kScaleRows = 1, kScaleK = 2 };

// acc[i][j] (the 16 x 8 tile at rows 16 i, columns 8 j of the warp's tile) +=
// A . B over k in [0, kdim), kdim % 8 == 0; A(m, k) = a[m * AM + k * AK],
// B(k, n) = b[k * BK + n * BN], f32 in shared memory, widened at the fragment
// load. kScaleRows multiplies A(m, k) by sc[m], kScaleK by sc[k] (in f32,
// before widening).
template <int MI, int NI, int AM, int AK, int BK, int BN, int SC = kNoScale>
static __device__ __forceinline__ void mma_tile(double (&acc)[MI][NI][4], const float* a,
                                                const float* b, int kdim,
                                                const float* sc = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ap = a + g * AM + t * AK;
  const float* bp = b + t * BK + g * BN;
  float rs[MI][2];
  if constexpr (SC == kScaleRows) {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      rs[i][0] = sc[16 * i + g];
      rs[i][1] = sc[16 * i + g + 8];
    }
  }
#pragma unroll 2
  for (int k0 = 0; k0 < kdim; k0 += 8) {
    double af[MI][4], bf[NI][2];
    float k0s = 1.f, k1s = 1.f;
    if constexpr (SC == kScaleK) {
      k0s = sc[k0 + t];
      k1s = sc[k0 + t + 4];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const float* p = ap + 16 * i * AM + k0 * AK;
      float v0 = p[0], v1 = p[8 * AM], v2 = p[4 * AK], v3 = p[8 * AM + 4 * AK];
      if constexpr (SC == kScaleRows) {
        v0 *= rs[i][0];
        v1 *= rs[i][1];
        v2 *= rs[i][0];
        v3 *= rs[i][1];
      }
      if constexpr (SC == kScaleK) {
        v0 *= k0s;
        v1 *= k0s;
        v2 *= k1s;
        v3 *= k1s;
      }
      af[i][0] = v0;
      af[i][1] = v1;
      af[i][2] = v2;
      af[i][3] = v3;
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const float* p = bp + k0 * BK + 8 * j * BN;
      bf[j][0] = p[0];
      bf[j][1] = p[4 * BK];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) dmma(acc[i][j], af[i], bf[j]);
  }
}

template <int MI, int NI>
static __device__ __forceinline__ void zero(double (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
}

// the row and column, within the warp's tile, of accumulator element e of tile (i, j)
static __device__ __forceinline__ int acc_row(int i, int e) {
  return 16 * i + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
static __device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// --- cp.async staging: src-size 0 fills zeros
static __device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
static __device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
static __device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
static __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An R x C tile of a row-major matrix g (row stride ld floats) into shared
// s[R][S]: element (r, c) from g[r * ld + c] if r < rows and c < cols, else 0.
// vec: 16-byte copies (needs cols, ld and g 4-float aligned).
template <int R, int C, int S>
static __device__ __forceinline__ void stage(float* s, const float* g, long ld, int rows,
                                             int cols, bool vec) {
  static_assert(C % 4 == 0 && S % 4 == 0, "16-byte rows");
  if (vec) {
    for (int e = threadIdx.x; e < R * (C / 4); e += kThreads) {
      const int r = e / (C / 4), c = e % (C / 4) * 4;
      const bool ok = r < rows && c < cols;
      cp_async16(s + r * S + c, ok ? g + r * ld + c : g, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += kThreads) {
      const int r = e / C, c = e % C;
      const bool ok = r < rows && c < cols;
      cp_async4(s + r * S + c, ok ? g + r * ld + c : g, ok);
    }
  }
}

// Inclusive prefix sum over the block's threads in a fixed order (warp
// scans, then the warp totals); `total` gets the block's sum. wsum: kWarps
// doubles of shared memory. Barriers inside, one at the end, so calls may
// follow each other.
static __device__ double block_scan(double v, double* wsum, double& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double u = lane < kWarps ? wsum[lane] : 0.0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const double s = __shfl_up_sync(kFull, u, o);
      if (lane >= o) u += s;
    }
    if (lane < kWarps) wsum[lane] = u;
  }
  __syncthreads();
  if (warp > 0) v += wsum[warp - 1];
  total = wsum[kWarps - 1];
  __syncthreads();
  return v;
}

// cs (f64) and dt of one chunk into shared memory; dtc points at dt[b, c0, h]
static __device__ void chunk_cs(const float* __restrict__ dtc, int H, int K, float a,
                                double* cs_s, float* dt_s, double* wsum) {
  const int t = threadIdx.x;
  const float d = t < K ? __ldg(dtc + (long)t * H) : 0.f;
  double total;
  const double v = block_scan(t < K ? static_cast<double>(d * a) : 0.0, wsum, total);
  if (t < K) {
    cs_s[t] = v;
    dt_s[t] = d;
  }
  __syncthreads();
}

}  // namespace ssd_f32
