// SSD (Mamba-2) chunk scan, backward, for Hopper (sm_90a).
//
// The gradient of ssd_scan.cu's forward: the TPU kernel
// src/repro/kernels/ssd_scan/kernel.py (ssd_scan) has none; the reference
// trains through autodiff of its plain chunked lax.scan
// (src/repro/models/ssm.py, ssm_train). Inputs x (B, L, H, P), Bm and Cm
// (B, L, N) shared by every head, dt (B, L, H), A (H,), the state entering
// each chunk `states` (B, L / K, H, N, P) that the forward's training
// instance writes, y's cotangent dy (B, L, H, P) and h_final's dh_final
// (B, H, N, P, or null for zero), all f32. Outputs dx, dB, dC, ddt, dA, each
// shaped as its input. The plain version, with the formulas, is
// kernels/ssd_scan/ref.py::ssd_scan_bwd_ref. Per (b, h) and chunk, with
// cs = cumsum(a dt), G_ij = C_i . B_j, L_ij = exp(cs_i - cs_j) and
// W_ij = G_ij L_ij dt_j for j <= i, w_j = dt_j exp(cs_last - cs_j),
// dW_ij = dy_i . x_j, dh the cotangent of the state leaving the chunk and
// h- the state entering it:
//
//   dx_j  = sum_{i>=j} W_ij dy_i + w_j (B_j . dh)
//   dC_i  = sum_{j<=i} dW_ij L_ij dt_j B_j + exp(cs_i) (h- . dy_i)
//   dB_j  = sum_{i>=j} dW_ij L_ij dt_j C_i + w_j (dh . x_j)
//   ddt_j = sum_{i>=j} dW_ij G_ij L_ij + exp(cs_last - cs_j) u_j + a sum_{i>=j} dcs_i
//   dh-   = exp(cs_last) dh + sum_i exp(cs_i) C_i (x) dy_i
//
// Bound on this card: operations. At mamba2-780m's training shape (B 8,
// L 512, H 48, P 64, N 128, K 256) the products need ~32.5 GFLOP (the
// causal half of each K x K product, C . B^T once per (b, chunk); see
// chip_smoke.py's ssd_bwd_work) against ~0.19 GB of inputs and outputs:
// ~0.20 ms at the 165 TFLOP/s of 3xTF32 tensor-core products, ~0.06 ms of
// bytes. This first kernel runs every product on the CUDA cores in f32
// (67 TFLOP/s at best), from register tiles fed by 16-byte shared-memory
// loads: simple and right first, and exact f32, since 3xTF32 does not keep
// full-width training gradients within their 1e-4 (see the training
// forward in ssd_scan.cu).
//
// Deterministic: no atomics. Every sum has one owner thread or a fixed
// tree (warp butterflies, then warp totals in order), so two runs give the
// same bits. What several heads or chunks share goes through partial
// buffers in `scratch` reduced in a fixed order by a later launch. Six
// launches on the caller's stream:
//
// 1. g_kernel (ssd_f32.cuh): G = C . B^T, K x K per (b, chunk), the tiles
//    on or below the diagonal (it does not depend on the head).
// 2. ssd_bwd_state_kernel, a CTA per (b, h): the reverse sweep over the
//    chunks, dh (N x P) in registers, writing the dh that enters each chunk
//    from the right, and exp(cs_last) sum(h- * dh), a term of dcs_last.
// 3. ssd_bwd_row_kernel, a CTA per (64-token row block i, chunk, h, b): dC's
//    per-head part and dcs's row terms, the score tiles of j <= i recomputed.
// 4. ssd_bwd_col_kernel, a CTA per (64-token column block j, chunk, h, b):
//    dx, dB's per-head part, dt's direct terms and dcs's column terms.
// 5. ssd_bwd_dt_kernel, a CTA per (b, h): dcs, its reverse cumsum R, ddt,
//    and sum dt R per (b, h) for dA.
// 6. ssd_bwd_reduce_kernel: dB and dC summed over heads, dA over batch.
//
// cs is summed in f64 (a dt rounded to f32 first), as the plain version
// sums it: over a chunk of 256 it runs to -O(500), and differences of f32
// sums that deep carry ~1e-4 of relative error, in an order-dependent way.
// dcs, R and dA are summed in f64 too: each S_ij enters dcs_i and dcs_j
// with opposite signs, and dA weighs dcs_i by cumsum(dt)_i (up to ~200), so
// f32 rounding of the row and column sums, which does not cancel, would
// reach dA amplified by that weight.
//
// Any K <= 256 with L % K == 0, N <= 128 and P <= 64: rows and columns past
// K, N or P are staged as zero and never written.

#include <cuda_runtime.h>

#include <cstdint>

#include "ssd_f32.cuh"

using namespace ssd_f32;

namespace {

// scratch, in floats: dA's partials (B x H doubles), dcs's column and row
// terms (two B x H x L planes of doubles), G, the dh entering each chunk,
// dB's and dC's per-head partials, two per-token float planes (dt's direct
// terms, w_j u_j), and exp(cs_last) sum(h- * dh) per (b, h, chunk)
struct Layout {
  long dA, dcs, g, dstates, dBp, dCp, vec, hterm, total;
  __host__ __device__ Layout(int B, int L, int H, int P, int N, int K) {
    const long nC = L / K;
    dA = 0;
    dcs = 2L * B * H;
    g = dcs + 4L * B * H * L;
    dstates = g + (long)B * L * K;
    dBp = dstates + (long)B * nC * H * N * P;
    dCp = dBp + (long)B * H * L * N;
    vec = dCp + (long)B * H * L * N;
    hterm = vec + 2L * B * H * L;
    total = hterm + (long)B * H * nC;
  }
};
enum { kColDcs = 0, kRowDcs = 1 };   // planes of doubles at dcs
enum { kDdtDirect = 0, kWu = 1 };    // planes of floats at vec

// 2. The reverse sweep of dh, a CTA per (h, b). Thread (tn, tp) owns
// dh[tn + 32 r][tp + 8 q], r < 4, q < 8. Per chunk: the dh entering it from
// the right to dstates, exp(cs_last) sum(h- * dh) to hterm, then
// dh <- exp(cs_last) dh + sum_i exp(cs_i) C_i (x) dy_i over tiles of 32 tokens.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const float* __restrict__ Cm, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ states,
                     const float* __restrict__ dy, const float* __restrict__ dh_final,
                     float* __restrict__ scratch, int L, int H, int P, int N, int K) {
  __shared__ __align__(16) float c_tile[32 * kS128], dy_tile[32 * kS64];
  __shared__ double cs_s[kMaxChunk], wsum[kWarps];
  __shared__ float dt_s[kMaxChunk];
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y, nC = L / K;
  const int tid = threadIdx.x, tn = tid >> 3, tp = tid & 7;
  const Layout lay(B, L, H, P, N, K);
  const float a = A[h];
  const long tokH = (long)H * P;
  float dh[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tn + 32 * r, p = tp + 8 * q;
      dh[r][q] = dh_final != nullptr && n < N && p < P
                     ? dh_final[(((long)b * H + h) * N + n) * P + p]
                     : 0.f;
    }
  for (int c = nC - 1; c >= 0; --c) {
    const int c0 = c * K;
    chunk_cs(dt + ((long)b * L + c0) * H + h, H, K, a, cs_s, dt_s, wsum);
    const long st = (((long)b * nC + c) * H + h) * N * P;
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tn + 32 * r, p = tp + 8 * q;
        if (n < N && p < P) {
          scratch[lay.dstates + st + (long)n * P + p] = dh[r][q];
          part += __ldg(states + st + (long)n * P + p) * dh[r][q];
        }
      }
    double total;
    block_scan(part, wsum, total);
    const float e_last = expf(static_cast<float>(cs_s[K - 1]));
    if (tid == 0)
      scratch[lay.hterm + ((long)b * H + h) * nC + c] = e_last * static_cast<float>(total);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) dh[r][q] *= e_last;
    const float* Cc = Cm + ((long)b * L + c0) * N;
    const float* dyc = dy + ((long)b * L + c0) * tokH + (long)h * P;
    for (int i0 = 0; i0 < K; i0 += 32) {
      for (int e = tid; e < 32 * kMaxN; e += kThreads) {
        const int r = e / kMaxN, n = e % kMaxN, i = i0 + r;
        c_tile[r * kS128 + n] = i < K && n < N
            ? expf(static_cast<float>(cs_s[i])) * __ldg(Cc + (long)i * N + n) : 0.f;
      }
      for (int e = tid; e < 32 * kMaxP; e += kThreads) {
        const int r = e / kMaxP, p = e % kMaxP, i = i0 + r;
        dy_tile[r * kS64 + p] = i < K && p < P ? __ldg(dyc + (long)i * tokH + p) : 0.f;
      }
      __syncthreads();
      const int rows = min(32, K - i0);
      for (int r = 0; r < rows; ++r) {
        float cv[4], yv[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) cv[k] = c_tile[r * kS128 + tn + 32 * k];
#pragma unroll
        for (int k = 0; k < 8; ++k) yv[k] = dy_tile[r * kS64 + tp + 8 * k];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 8; ++m) dh[k][m] += cv[k] * yv[m];
      }
      __syncthreads();
    }
  }
}

// shared memory of the row and column kernels, in floats: cs, wsum, a
// vector of doubles, dt, two vectors of floats
constexpr int kHead = 2 * kMaxChunk + 2 * kWarps + 2 * kT + kMaxChunk + 2 * kT;
constexpr int kRowSmem = kHead + kMaxP * kS64 + kMaxP * kS128 + kMaxN * kS64;
constexpr int kColSmem = kHead + kMaxP * kS64 + kMaxP * kS128 + 2 * kMaxN * kS64;
static_assert(kHead % 4 == 0, "16-byte aligned tiles");
static_assert(kMaxP * kS64 + kT * kS128 + kT * kS64 <= kMaxP * kS128 + kMaxN * kS64,
              "the row kernel's loop view fits its init view");
static_assert(2 * kMaxP * kS64 + kT * kS128 + 2 * kT * kS64 <= kMaxP * kS128 + 2 * kMaxN * kS64,
              "the column kernel's loop view fits its init view");

// The score tile of rows i0.., columns j0.. for one (b, h, chunk): dW = dy_i . x_j
// over P from dyt (P x rows) and xt (P x columns), both [p][token]; then for
// j <= i < K, W = G L dt_j, dG = dW L dt_j, S = dW W (j < i only), D = dW G L
// (0 elsewhere, by select); S summed along the thread's rows and columns (in
// f64), D along its columns. Thread owns rows 4 ri.., columns 4 rj..
struct Tile {
  float w[4][4], dg[4][4], d_col[4];
  double s_row[4], s_col[4];
};
__device__ __forceinline__ void score_tile(Tile& t, const float* dyt, const float* xt, int ri,
                                           int rj, int i0, int j0, int P, int K,
                                           const float* __restrict__ G, const double* cs_s,
                                           const float* dt_s) {
  float dw[4][4] = {};
  for (int p = 0; p < P; ++p) {
    const float4 yv = ld4(dyt + p * kS64 + 4 * ri), xv = ld4(xt + p * kS64 + 4 * rj);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) dw[r][s] += el(yv, r) * el(xv, s);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t.s_row[k] = t.s_col[k] = 0.0;
    t.d_col[k] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ri + r;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + 4 * rj + s;
      float w = 0.f, dg = 0.f, sv = 0.f, dv = 0.f;
      if (i < K && j <= i) {
        const float lij = expf(fminf(static_cast<float>(cs_s[i] - cs_s[j]), 0.f));
        const float gl = __ldg(G + (long)i * K + j) * lij;
        w = gl * dt_s[j];
        dg = dw[r][s] * lij * dt_s[j];
        sv = j < i ? dw[r][s] * w : 0.f;
        dv = dw[r][s] * gl;
      }
      t.w[r][s] = w;
      t.dg[r][s] = dg;
      t.s_row[r] += sv;
      t.s_col[s] += sv;
      t.d_col[s] += dv;
    }
  }
}

// 3. Row block ib (heaviest first), chunk, head, batch: dC's per-head part
// (dBp layout, B x H x L x N) and dcs's row terms, sum_{j<i} S_ij plus the
// inbound exp(cs_i) C_i . h- . dy_i. Thread (iq, nq) owns dC[4 iq + r][8 nq + k].
__global__ void __launch_bounds__(kThreads)
ssd_bwd_row_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ states,
                   const float* __restrict__ dy, float* __restrict__ scratch, int L, int H,
                   int P, int N, int K) {
  extern __shared__ float4 smem4[];
  double* cs_s = reinterpret_cast<double*>(smem4);
  double* wsum = cs_s + kMaxChunk;
  double* rowS = wsum + kWarps;
  float* dt_s = reinterpret_cast<float*>(rowS + kT);
  float* inb = dt_s + kMaxChunk;
  float* dyt = reinterpret_cast<float*>(smem4) + kHead;   // own dy, [p][i]
  float* U = dyt + kMaxP * kS64;
  float* hpt = U;                                // init: h-[n][p] at [p][n]
  float* ct = hpt + kMaxP * kS128;               //       own C[i][n] at [n][i]
  float* xt = U;                                 // loop: x of block j at [p][j]
  float* bn = xt + kMaxP * kS64;                 //       B[j][n] at [j][n]
  float* dgt = bn + kT * kS128;                  //       dG[i][j] at [j][i]

  const int nT = (K + kT - 1) / kT, ib = nT - 1 - blockIdx.x, i0 = ib * kT;
  const int c = blockIdx.y / H, h = blockIdx.y % H, b = blockIdx.z, nC = L / K, c0 = c * K;
  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const Layout lay(gridDim.z, L, H, P, N, K);
  const long tokH = (long)H * P;
  const float* xc = x + ((long)b * L + c0) * tokH + (long)h * P;
  const float* dyc = dy + ((long)b * L + c0) * tokH + (long)h * P;
  const float* Bc = Bm + ((long)b * L + c0) * N;
  const float* Cc = Cm + ((long)b * L + c0) * N;
  const float* hp = states + (((long)b * nC + c) * H + h) * N * P;
  const float* G = scratch + lay.g + ((long)b * nC + c) * K * K;

  for (int e = tid; e < kT * kMaxP; e += kThreads) {
    const int r = e / kMaxP, p = e % kMaxP, i = i0 + r;
    dyt[p * kS64 + r] = i < K && p < P ? __ldg(dyc + (long)i * tokH + p) : 0.f;
  }
  for (int e = tid; e < kMaxN * kMaxP; e += kThreads) {
    const int n = e / kMaxP, p = e % kMaxP;
    hpt[p * kS128 + n] = n < N && p < P ? __ldg(hp + (long)n * P + p) : 0.f;
  }
  for (int e = tid; e < kT * kMaxN; e += kThreads) {
    const int r = e / kMaxN, n = e % kMaxN, i = i0 + r;
    ct[n * kS64 + r] = i < K && n < N ? __ldg(Cc + (long)i * N + n) : 0.f;
  }
  if (tid < kT) rowS[tid] = 0.0;
  chunk_cs(dt + ((long)b * L + c0) * H + h, H, K, A[h], cs_s, dt_s, wsum);

  // inbound: dC_i = exp(cs_i) h- . dy_i, and its dcs term C_i . dC_i
  float dc[4][8] = {};
  for (int p = 0; p < P; ++p) {
    const float4 yv = ld4(dyt + p * kS64 + 4 * hi);
    const float4 h0 = ld4(hpt + p * kS128 + 8 * lo), h1 = ld4(hpt + p * kS128 + 8 * lo + 4);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dc[r][k] += el(yv, r) * el(h0, k);
        dc[r][k + 4] += el(yv, r) * el(h1, k);
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * hi + r;
    const float ecs = i < K ? expf(static_cast<float>(cs_s[i])) : 0.f;
    float in = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      dc[r][k] *= ecs;
      in += ct[(8 * lo + k) * kS64 + 4 * hi + r] * dc[r][k];
    }
    in = half_warp_sum(in);
    if (lo == 0) inb[4 * hi + r] = in;
  }
  __syncthreads();                               // the init view is read

  for (int jb = 0; jb <= ib; ++jb) {
    const int j0 = jb * kT;
    for (int e = tid; e < kT * kMaxP; e += kThreads) {
      const int r = e / kMaxP, p = e % kMaxP, j = j0 + r;
      xt[p * kS64 + r] = j < K && p < P ? __ldg(xc + (long)j * tokH + p) : 0.f;
    }
    for (int e = tid; e < kT * kMaxN; e += kThreads) {
      const int r = e / kMaxN, n = e % kMaxN, j = j0 + r;
      bn[r * kS128 + n] = j < K && n < N ? __ldg(Bc + (long)j * N + n) : 0.f;
    }
    __syncthreads();
    Tile t;                                      // rows 4 hi.., columns 4 lo..
    score_tile(t, dyt, xt, hi, lo, i0, j0, P, K, G, cs_s, dt_s);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      st4(dgt + (4 * lo + s) * kS64 + 4 * hi, t.dg[0][s], t.dg[1][s], t.dg[2][s], t.dg[3][s]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const double v = half_warp_sum(t.s_row[r]);
      if (lo == 0) rowS[4 * hi + r] += v;
    }
    __syncthreads();
    const int cols = min(kT, K - j0);
    for (int jj = 0; jj < cols; ++jj) {
      const float4 gv = ld4(dgt + jj * kS64 + 4 * hi);
      const float4 b0 = ld4(bn + jj * kS128 + 8 * lo), b1 = ld4(bn + jj * kS128 + 8 * lo + 4);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dc[r][k] += el(gv, r) * el(b0, k);
          dc[r][k + 4] += el(gv, r) * el(b1, k);
        }
    }
    __syncthreads();
  }

  float* dco = scratch + lay.dCp + (((long)b * H + h) * L + c0) * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * hi + r;
    if (i >= K) continue;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (8 * lo + k < N) dco[(long)i * N + 8 * lo + k] = dc[r][k];
  }
  if (tid < kT && i0 + tid < K)
    reinterpret_cast<double*>(scratch + lay.dcs)[(((long)kRowDcs * gridDim.z + b) * H + h) * L +
                                                 c0 + i0 + tid] = rowS[tid] + inb[tid];
}

// 4. Column block jb (heaviest first), chunk, head, batch: dx, dB's
// per-head part, ddt's direct terms, dcs's column terms -sum_{i>j} S_ij -
// w_j u_j, and w_j u_j. Thread (jq, pq) owns dx[4 jq + s][4 pq + q] and
// dB[4 jq + s][8 pq + k].
__global__ void __launch_bounds__(kThreads)
ssd_bwd_col_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ dy,
                   float* __restrict__ dx, float* __restrict__ scratch, int L, int H, int P,
                   int N, int K) {
  extern __shared__ float4 smem4[];
  double* cs_s = reinterpret_cast<double*>(smem4);
  double* wsum = cs_s + kMaxChunk;
  double* colS = wsum + kWarps;
  float* dt_s = reinterpret_cast<float*>(colS + kT);
  float* colD = dt_s + kMaxChunk;
  float* u_s = colD + kT;
  float* xt = reinterpret_cast<float*>(smem4) + kHead;    // own x, [p][j]
  float* U = xt + kMaxP * kS64;
  float* dht = U;                                // init: dh[n][p] at [p][n]
  float* dhn = dht + kMaxP * kS128;              //       dh[n][p] at [n][p]
  float* bt = dhn + kMaxN * kS64;                //       own B[j][n] at [n][j]
  float* dyt = U;                                // loop: dy of block i at [p][i]
  float* dyn = dyt + kMaxP * kS64;               //       at [i][p]
  float* cn = dyn + kT * kS64;                   //       C[i][n] at [i][n]
  float* ws = cn + kT * kS128;                   //       W[i][j]
  float* dgs = ws + kT * kS64;                   //       dG[i][j]

  const int jb = blockIdx.x, j0 = jb * kT, nT = (K + kT - 1) / kT;
  const int c = blockIdx.y / H, h = blockIdx.y % H, b = blockIdx.z, nC = L / K, c0 = c * K;
  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const Layout lay(gridDim.z, L, H, P, N, K);
  const long tokH = (long)H * P;
  const float* xc = x + ((long)b * L + c0) * tokH + (long)h * P;
  const float* dyc = dy + ((long)b * L + c0) * tokH + (long)h * P;
  const float* Bc = Bm + ((long)b * L + c0) * N;
  const float* Cc = Cm + ((long)b * L + c0) * N;
  const float* dhg = scratch + lay.dstates + (((long)b * nC + c) * H + h) * N * P;
  const float* G = scratch + lay.g + ((long)b * nC + c) * K * K;

  for (int e = tid; e < kT * kMaxP; e += kThreads) {
    const int r = e / kMaxP, p = e % kMaxP, j = j0 + r;
    xt[p * kS64 + r] = j < K && p < P ? __ldg(xc + (long)j * tokH + p) : 0.f;
  }
  for (int e = tid; e < kMaxN * kMaxP; e += kThreads) {
    const int n = e / kMaxP, p = e % kMaxP;
    const float v = n < N && p < P ? dhg[(long)n * P + p] : 0.f;
    dht[p * kS128 + n] = v;
    dhn[n * kS64 + p] = v;
  }
  for (int e = tid; e < kT * kMaxN; e += kThreads) {
    const int r = e / kMaxN, n = e % kMaxN, j = j0 + r;
    bt[n * kS64 + r] = j < K && n < N ? __ldg(Bc + (long)j * N + n) : 0.f;
  }
  if (tid < kT) {
    colS[tid] = 0.0;
    colD[tid] = 0.f;
  }
  chunk_cs(dt + ((long)b * L + c0) * H + h, H, K, A[h], cs_s, dt_s, wsum);
  const double cs_last = cs_s[K - 1];

  float wj[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = j0 + 4 * hi + s;
    wj[s] = j < K ? dt_s[j] * expf(static_cast<float>(cs_last - cs_s[j])) : 0.f;
  }
  // v_j = dh . x_j (into db), u_j = B_j . v_j, then db = w_j v_j
  float db[4][8] = {};
  for (int p = 0; p < P; ++p) {
    const float4 xv = ld4(xt + p * kS64 + 4 * hi);
    const float4 d0 = ld4(dht + p * kS128 + 8 * lo), d1 = ld4(dht + p * kS128 + 8 * lo + 4);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        db[s][k] += el(xv, s) * el(d0, k);
        db[s][k + 4] += el(xv, s) * el(d1, k);
      }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float u = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      u += bt[(8 * lo + k) * kS64 + 4 * hi + s] * db[s][k];
      db[s][k] *= wj[s];
    }
    u = half_warp_sum(u);
    if (lo == 0) u_s[4 * hi + s] = u;
  }
  // dx_j = w_j B_j . dh
  float dxa[4][4] = {};
  for (int n = 0; n < N; ++n) {
    const float4 bv = ld4(bt + n * kS64 + 4 * hi), dv = ld4(dhn + n * kS64 + 4 * lo);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) dxa[s][q] += el(bv, s) * el(dv, q);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) dxa[s][q] *= wj[s];
  __syncthreads();                               // the init view is read

  for (int ib = jb; ib < nT; ++ib) {
    const int i0 = ib * kT;
    for (int e = tid; e < kT * kMaxP; e += kThreads) {
      const int r = e / kMaxP, p = e % kMaxP, i = i0 + r;
      const float v = i < K && p < P ? __ldg(dyc + (long)i * tokH + p) : 0.f;
      dyt[p * kS64 + r] = v;
      dyn[r * kS64 + p] = v;
    }
    for (int e = tid; e < kT * kMaxN; e += kThreads) {
      const int r = e / kMaxN, n = e % kMaxN, i = i0 + r;
      cn[r * kS128 + n] = i < K && n < N ? __ldg(Cc + (long)i * N + n) : 0.f;
    }
    __syncthreads();
    Tile t;                                      // rows 4 lo.., columns 4 hi..
    score_tile(t, dyt, xt, lo, hi, i0, j0, P, K, G, cs_s, dt_s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      st4(ws + (4 * lo + r) * kS64 + 4 * hi, t.w[r][0], t.w[r][1], t.w[r][2], t.w[r][3]);
      st4(dgs + (4 * lo + r) * kS64 + 4 * hi, t.dg[r][0], t.dg[r][1], t.dg[r][2], t.dg[r][3]);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const double sv = half_warp_sum(t.s_col[s]);
      const float dv = half_warp_sum(t.d_col[s]);
      if (lo == 0) {
        colS[4 * hi + s] += sv;
        colD[4 * hi + s] += dv;
      }
    }
    __syncthreads();
    const int rows = min(kT, K - i0);
    for (int ii = 0; ii < rows; ++ii) {
      const float4 wv = ld4(ws + ii * kS64 + 4 * hi), yv = ld4(dyn + ii * kS64 + 4 * lo);
      const float4 gv = ld4(dgs + ii * kS64 + 4 * hi);
      const float4 c0v = ld4(cn + ii * kS128 + 8 * lo), c1v = ld4(cn + ii * kS128 + 8 * lo + 4);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dxa[s][q] += el(wv, s) * el(yv, q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          db[s][k] += el(gv, s) * el(c0v, k);
          db[s][k + 4] += el(gv, s) * el(c1v, k);
        }
      }
    }
    __syncthreads();
  }

  float* dxo = dx + ((long)b * L + c0) * tokH + (long)h * P;
  float* dbo = scratch + lay.dBp + (((long)b * H + h) * L + c0) * N;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = j0 + 4 * hi + s;
    if (j >= K) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * lo + q < P) dxo[(long)j * tokH + 4 * lo + q] = dxa[s][q];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (8 * lo + k < N) dbo[(long)j * N + 8 * lo + k] = db[s][k];
  }
  if (tid < kT && j0 + tid < K) {
    const int j = j0 + tid;
    const float eo = expf(static_cast<float>(cs_last - cs_s[j]));
    const float u = u_s[tid], wu = dt_s[j] * eo * u;
    const long v = ((long)b * H + h) * L + c0 + j, plane = (long)gridDim.z * H * L;
    reinterpret_cast<double*>(scratch + lay.dcs)[kColDcs * plane + v] = -colS[tid] - wu;
    scratch[lay.vec + kDdtDirect * plane + v] = colD[tid] + eo * u;
    scratch[lay.vec + kWu * plane + v] = wu;
  }
}

// 5. dcs per chunk, R_t = sum_{i>=t} dcs_i, ddt = direct + a R, and
// sum_t dt_t R_t over the chunks of one (b, h) into dA's partial; a CTA per
// (h, b), a thread a token.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  float* __restrict__ ddt, float* __restrict__ scratch, int L, int H, int P,
                  int N, int K) {
  __shared__ double wsum[kWarps], dcs_s[kMaxChunk];
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y, nC = L / K, t = threadIdx.x;
  const Layout lay(B, L, H, P, N, K);
  const long plane = (long)B * H * L, row = ((long)b * H + h) * L;
  const double a = A[h];
  double dA = 0.0;
  for (int c = 0; c < nC; ++c) {
    const long v = row + (long)c * K + t;
    const float* vec = scratch + lay.vec;
    const double* dcs = reinterpret_cast<const double*>(scratch + lay.dcs);
    double total;
    block_scan(t < K ? static_cast<double>(vec[kWu * plane + v]) : 0.0, wsum, total);
    if (t < K) {
      double d = dcs[kRowDcs * plane + v] + dcs[kColDcs * plane + v];
      if (t == K - 1)
        d += total + static_cast<double>(scratch[lay.hterm + ((long)b * H + h) * nC + c]);
      dcs_s[t] = d;
    }
    __syncthreads();
    // thread t scans token K - 1 - t: the reverse cumsum
    const int rt = K - 1 - t;
    const double r = block_scan(t < K ? dcs_s[rt] : 0.0, wsum, total);
    if (t < K) dcs_s[rt] = r;
    __syncthreads();
    double part = 0.0;
    if (t < K) {
      const double R = dcs_s[t];
      const long l = ((long)b * L + (long)c * K + t) * H + h;
      ddt[l] = vec[kDdtDirect * plane + v] + static_cast<float>(a * R);
      part = static_cast<double>(dt[l]) * R;
    }
    block_scan(part, wsum, total);
    dA += total;
  }
  if (t == 0) reinterpret_cast<double*>(scratch + lay.dA)[(long)b * H + h] = dA;
}

// 6. dB, dC = the per-head partials summed over h in order; dA over b.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ dA,
                      const float* __restrict__ scratch, int B, int L, int H, int P, int N,
                      int K) {
  const Layout lay(B, L, H, P, N, K);
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x, plane = (long)L * N;
  if (idx < (long)B * plane) {
    const long b = idx / plane, r = idx % plane;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const long off = (b * H + h) * plane + r;
      sb += scratch[lay.dBp + off];
      sc += scratch[lay.dCp + off];
    }
    dB[idx] = sb;
    dC[idx] = sc;
  }
  if (idx < H) {
    const double* part = reinterpret_cast<const double*>(scratch + lay.dA);
    double s = 0.0;
    for (int b = 0; b < B; ++b) s += part[(long)b * H + idx];
    dA[idx] = static_cast<float>(s);
  }
}

}  // namespace

// Floats of scratch ssd_scan_bwd needs at these shapes (0 if L % chunk != 0).
extern "C" long long ssd_scan_bwd_scratch_floats(int B, int L, int H, int P, int N,
                                                 int chunk) {
  if (chunk <= 0 || L % chunk != 0) return 0;
  return Layout(B, L, H, P, N, chunk).total;
}

// dh_final may be null (a zero cotangent). scratch holds
// ssd_scan_bwd_scratch_floats(...) floats, 8-byte aligned. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int ssd_scan_bwd(const void* x, const void* Bm, const void* Cm, const void* dt,
                            const void* A, const void* states, const void* dy,
                            const void* dh_final, void* dx, void* dB, void* dC, void* ddt,
                            void* dA, void* scratch, int B, int L, int H, int P, int N,
                            int chunk, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || L <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      L % chunk != 0 || (long)(L / chunk) * H > 65535 || H > 65535 || N <= 0 ||
      N > kMaxN || P <= 0 || P > kMaxP || scratch == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr_row = cudaFuncSetAttribute(
      ssd_bwd_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRowSmem * static_cast<int>(sizeof(float)));
  static const cudaError_t attr_col = cudaFuncSetAttribute(
      ssd_bwd_col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kColSmem * static_cast<int>(sizeof(float)));
  if (attr_row != cudaSuccess) return static_cast<int>(attr_row);
  if (attr_col != cudaSuccess) return static_cast<int>(attr_col);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nC = L / chunk, nT = (chunk + kT - 1) / kT;
  const float *fx = static_cast<const float*>(x), *fB = static_cast<const float*>(Bm),
              *fC = static_cast<const float*>(Cm), *fdt = static_cast<const float*>(dt),
              *fA = static_cast<const float*>(A), *fst = static_cast<const float*>(states),
              *fdy = static_cast<const float*>(dy), *fdh = static_cast<const float*>(dh_final);
  float* sc = static_cast<float*>(scratch);
  cudaError_t e;
  const Layout lay(B, L, H, P, N, chunk);
  g_kernel<<<dim3(nT * nT, nC, B), kThreads, 0, s>>>(fB, fC, sc + lay.g, L, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_state_kernel<<<dim3(H, B), kThreads, 0, s>>>(fC, fdt, fA, fst, fdy, fdh, sc, L, H,
                                                       P, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_row_kernel<<<dim3(nT, nC * H, B), kThreads, kRowSmem * sizeof(float), s>>>(
      fx, fB, fC, fdt, fA, fst, fdy, sc, L, H, P, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_col_kernel<<<dim3(nT, nC * H, B), kThreads, kColSmem * sizeof(float), s>>>(
      fx, fB, fC, fdt, fA, fdy, static_cast<float*>(dx), sc, L, H, P, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dt_kernel<<<dim3(H, B), kThreads, 0, s>>>(fdt, fA, static_cast<float*>(ddt), sc, L,
                                                    H, P, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long cells = (long)B * L * N;
  const long blocks = ((cells > H ? cells : H) + kThreads - 1) / kThreads;
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<float*>(dB), static_cast<float*>(dC), static_cast<float*>(dA), sc, B, L, H,
      P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}
