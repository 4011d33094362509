// f32 pieces shared by the SSD scan's training forward (ssd_scan.cu,
// ssd_scan_fwd_states) and its backward (ssd_scan_bwd.cu): sizes, 16-byte
// shared-memory access, a deterministic block scan, the chunk's cs summed in
// f64, and C . B^T on the CUDA cores. Every function is static, so each
// library that includes this has its own copy.

#pragma once

#include <cuda_runtime.h>

namespace ssd_f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;                           // tokens a row or column block
constexpr int kMaxChunk = 256, kMaxN = 128, kMaxP = 64;
constexpr int kS64 = 68;                         // shared row strides: 16-byte
constexpr int kS128 = 132;                       // aligned, banks staggered
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMaxChunk <= kThreads, "the chunk scans give one token per thread");
static_assert(kT * 4 == kThreads, "a 64 x 64 tile is 4 x 4 a thread");

static __device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
static __device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
static __device__ __forceinline__ float el(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
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

// sum over the 16 lanes of a half warp, the same bits in each
template <class T>
static __device__ __forceinline__ T half_warp_sum(T v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// G_ij = C_i . B_j, K x K per (b, chunk) into G (B, L / K, K, K), over the
// 64 x 64 tiles at or below the diagonal; grid (nT * nT, L / K, B), thread
// (a, q) owns rows 4a.., columns 4q.. of a tile
static __global__ void __launch_bounds__(kThreads)
g_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ G,
         int L, int N, int K) {
  __shared__ __align__(16) float ct[32 * kS64], bt[32 * kS64];
  const int nT = (K + kT - 1) / kT, ti = blockIdx.x / nT, tj = blockIdx.x % nT;
  if (tj > ti) return;
  const int c = blockIdx.y, b = blockIdx.z, nC = L / K, tid = threadIdx.x;
  const long row0 = (long)b * L + (long)c * K;
  const float* Cc = Cm + (row0 + ti * kT) * N;
  const float* Bc = Bm + (row0 + tj * kT) * N;
  const int ri = K - ti * kT, rj = K - tj * kT;  // rows of the blocks that exist
  const int a = tid >> 4, q = tid & 15;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += 32) {
    for (int e = tid; e < kT * 32; e += kThreads) {
      const int r = e >> 5, nn = e & 31, n = n0 + nn;
      ct[nn * kS64 + r] = r < ri && n < N ? __ldg(Cc + (long)r * N + n) : 0.f;
      bt[nn * kS64 + r] = r < rj && n < N ? __ldg(Bc + (long)r * N + n) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < 32; ++nn) {
      const float4 cv = ld4(ct + nn * kS64 + 4 * a), bv = ld4(bt + nn * kS64 + 4 * q);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] += el(cv, r) * el(bv, s);
    }
    __syncthreads();
  }
  float* Gc = G + ((long)b * nC + c) * K * K;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti * kT + 4 * a + r;
    if (i >= K) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = tj * kT + 4 * q + s;
      if (j < K) Gc[(long)i * K + j] = acc[r][s];
    }
  }
}

}  // namespace ssd_f32
