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
// dW_ij = dy_i . x_j, dG_ij = dW_ij L_ij dt_j, dh the cotangent of the state
// leaving the chunk and h- the state entering it:
//
//   dx_j  = sum_{i>=j} W_ij dy_i + w_j (B_j . dh)
//   dC_i  = sum_{j<=i} dG_ij B_j + exp(cs_i) (h- . dy_i)
//   dB_j  = sum_{i>=j} dG_ij C_i + w_j (dh . x_j)
//   ddt_j = sum_{i>=j} dW_ij G_ij L_ij + exp(cs_last - cs_j) u_j + a sum_{i>=j} dcs_i
//   dh-   = exp(cs_last) dh + sum_i exp(cs_i) C_i (x) dy_i
//
// dB and dC are summed over heads, and B and C are shared by every head, so
// their K x K terms are (sum_h dG^h) . B and (sum_h dG^h)^T . C: dG is summed
// over heads first and the products with B and C run once per (b, chunk), not
// once per head. The inbound and outbound terms, summed over heads, are
// products of depth H P: (exp(cs) dy)[i][(h, p)] . h-[(h, p)][n] and
// (w x)[j][(h, p)] . dh[(h, p)][n].
//
// Bound on this card: operations. At mamba2-780m's training shape (B 8,
// L 512, H 48, P 64, N 128, K 256) the function needs 32.5 GFLOP when each
// head's dG meets B and C on its own (chip_smoke.py's ssd_bwd_work):
// 0.197 ms at the 165 TFLOP/s of 3xTF32 tensor-core products, 0.485 ms at
// the 67 TFLOP/s of the FP64 tensor cores this kernel runs; ~0.19 GB of
// inputs and outputs take 0.056 ms. Summing dG over heads first cuts the
// work to ~21 GFLOP (chip_smoke.py's ssd_bwd_work, as the kernels line counts
// it): 0.31 ms on the FP64 tensor cores. Every product is
// mma.sync.m16n8k8 f64 (ssd_f32.cuh): f32 operands staged by cp.async into
// two-stage rings in their natural [token][feature] layout, widened at the
// fragment load; exact products and f64 sums, where 3xTF32 does not keep
// full-width training gradients within their 1e-4 (see ssd_f32.cuh).
//
// Deterministic: no atomics. Every sum has one owner thread or a fixed
// order (warp butterflies, then warp partials in order; partial buffers in
// `scratch` summed in order by a later launch), so two runs give the same
// bits. Six launches on the caller's stream:
//
// 1. g_kernel: G = C . B^T, K x K per (b, chunk), the tiles on or below the
//    diagonal.
// 2. ssd_bwd_state_kernel, a CTA per (b, h, 32 columns of P): the reverse
//    sweep over the chunks, dh (N x 32) in f64 accumulators, writing the dh
//    that enters each chunk from the right, cs (which launches 3, 4 and 6
//    read), exp(cs_last) sum(h- * dh)
//    (a term of dcs_last) and the inbound dcs term exp(cs_i) dy_i . (C_i h-).
// 3. ssd_bwd_tile_kernel, a CTA per (64 x 64 score tile, chunk, group of 8
//    heads, b): per head dW once, then dG summed over the group's heads, and
//    the row and column sums of S_ij = dW_ij W_ij and of dW_ij G_ij L_ij.
// 4. ssd_bwd_dx_kernel, a CTA per (64-token column block, chunk, h, b): dx
//    from W (which needs no dW), with u_j = B_j . dh . x_j.
// 5. ssd_bwd_dt_kernel, a CTA per (b, h): dcs, its reverse cumsum R, ddt, and
//    sum dt R per (b, h) for dA.
// 6. ssd_bwd_dbc_kernel, a CTA per (64 rows, 64 or 16 state columns, dB or
//    dC, chunk, b): the summed dG's products with B or C, then the inbound
//    or outbound term over every head; dA summed over batch.
//
// dW is computed once per score tile and head (launch 3); launch 4 rebuilds
// only W from G. Shared memory stays at 66-91 KB a CTA, so two CTAs fit an
// SM; launches 2, 3 and 6 are held to 128 registers to make that so (they
// spill 40-160 bytes a thread), which took the backward from 1.383 to
// 1.169 ms at mamba2's training shape on an NVIDIA H100 80GB HBM3 (700 W;
// tools/ssd_bwd_ab.py), launch 4 runs at 80. The partial sums of dG over
// groups of heads take (H / 8) K x K floats a (b, chunk), 15.7 MB at
// mamba2's shape against the 2 x 100.7 MB of per-head dB and dC partials a
// CUDA-core design wrote.
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

constexpr int kHG = 8;                           // heads a tile CTA sums dG over

// The elements of G (the chunk's K x K C . B^T) of the 64 x 64 tile at rows
// i0, columns j0 that w_tile's thread writes, 0 off j <= i < K: loaded a tile
// ahead, so their latency hides behind a tile's products
constexpr int kTileElems = kT * kT / kThreads;
__device__ __forceinline__ void g_regs(float (&gv)[kTileElems],
                                              const float* __restrict__ G, int i0, int j0,
                                              int K) {
#pragma unroll
  for (int k = 0; k < kTileElems; ++k) {
    const int e = threadIdx.x + k * kThreads, i = i0 + (e >> 6), j = j0 + (e & 63);
    gv[k] = i < K && j <= i ? __ldg(G + (long)i * K + j) : 0.f;
  }
}

// W_ij = G_ij exp(cs_i - cs_j) dt_j for j <= i < K, else 0 (by select: above
// the diagonal the exponent is positive), of the 64 x 64 tile at rows i0,
// columns j0 into w[64][kS64], from g_regs' values
__device__ __forceinline__ void w_tile(float* w, const float (&gv)[kTileElems],
                                              const double* cs_s, const float* dt_s, int i0,
                                              int j0, int K) {
#pragma unroll
  for (int k = 0; k < kTileElems; ++k) {
    const int e = threadIdx.x + k * kThreads, r = e >> 6, s = e & 63, i = i0 + r, j = j0 + s;
    float v = 0.f;
    if (i < K && j <= i)
      v = gv[k] * expf(fminf(static_cast<float>(cs_s[i] - cs_s[j]), 0.f)) * dt_s[j];
    w[r * kS64 + s] = v;
  }
}

// G_ij = C_i . B_j, K x K per (b, chunk) into G (B, L / K, K, K), the 64 x 64
// tiles on or below the diagonal, a CTA a tile; grid (nT * nT, L / K, B).
// Over N in steps of 32 through a two-stage cp.async ring; warp (wm, wn) owns
// rows 32 wm.., columns 16 wn.. of the tile.
__global__ void __launch_bounds__(kThreads)
g_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ G,
         int L, int N, int K) {
  __shared__ __align__(16) float ct[2][kT * kS32], bt[2][kT * kS32];
  const int nT = cdiv(K, kT), ti = blockIdx.x / nT, tj = blockIdx.x % nT;
  if (tj > ti) return;
  const int c = blockIdx.y, b = blockIdx.z, nC = L / K;
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const long row0 = (long)b * L + (long)c * K;
  const float* Cc = Cm + (row0 + ti * kT) * N;
  const float* Bc = Bm + (row0 + tj * kT) * N;
  const int ri = K - ti * kT, rj = K - tj * kT;  // rows of the blocks that exist
  const bool vec = N % 4 == 0;
  const int steps = cdiv(N, 32);
  double acc[2][2][4];
  zero(acc);
  stage<kT, 32, kS32>(ct[0], Cc, N, ri, N, vec);
  stage<kT, 32, kS32>(bt[0], Bc, N, rj, N, vec);
  cp_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      const int n0 = (s + 1) * 32;
      stage<kT, 32, kS32>(ct[(s + 1) & 1], Cc + n0, N, ri, N - n0, vec);
      stage<kT, 32, kS32>(bt[(s + 1) & 1], Bc + n0, N, rj, N - n0, vec);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    mma_tile<2, 2, kS32, 1, 1, kS32>(acc, ct[s & 1] + 32 * wm * kS32,
                                      bt[s & 1] + 16 * wn * kS32, 32);
    __syncthreads();
  }
  float* Gc = G + ((long)b * nC + c) * K * K;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = ti * kT + 32 * wm + acc_row(i, e), q = tj * kT + 16 * wn + acc_col(j, e);
        if (r < K && q < K) Gc[(long)r * K + q] = static_cast<float>(acc[i][j][e]);
      }
}


// scratch, in floats: dA's partials (B x H doubles), cs (B x H x L doubles),
// the inbound dcs term (a plane of doubles per 32 columns of P), the row sums
// of S (a plane of doubles per column block) and its column sums (a plane per
// row block), exp(cs_last) sum(h- * dh) (doubles per 32 columns of P, b, h,
// chunk), G, the dh entering each chunk, dG summed over each group of heads,
// the column sums of dW G L (a float plane per row block), and two per-token
// float planes: exp(cs_last - cs_j) u_j and w_j u_j
struct Layout {
  long dA, cs, dcsin, rowS, colS, hterm, g, dstates, gsum, colD, vec, total;
  __host__ __device__ Layout(int B, int L, int H, int P, int N, int K) {
    const long nC = L / K, nT = cdiv(K, kT), nPh = cdiv(P, kPh), nG = cdiv(H, kHG);
    const long bhl = (long)B * H * L;
    long o = 0;                                  // every region starts 16-byte aligned
    dA = take(o, 2L * B * H);
    cs = take(o, 2 * bhl);
    dcsin = take(o, 2 * nPh * bhl);
    rowS = take(o, 2 * nT * bhl);
    colS = take(o, 2 * nT * bhl);
    hterm = take(o, 2 * nPh * B * H * nC);
    g = take(o, (long)B * nC * K * K);
    dstates = take(o, (long)B * nC * H * N * P);
    gsum = take(o, nG * B * nC * K * K);
    colD = take(o, nT * bhl);
    vec = take(o, 2 * bhl);
    total = o;
  }
  __host__ __device__ static long take(long& o, long floats) {
    const long at = o;
    o += (floats + 3) & ~3L;
    return at;
  }
};
enum { kEoU = 0, kWu = 1 };                      // planes of floats at vec

__device__ __forceinline__ double* dplane(float* scratch, long off) {
  return reinterpret_cast<double*>(scratch + off);
}

// cs of one chunk of one (b, h), as the state sweep wrote it (the same bits
// chunk_cs gives), and dt into shared memory; no barrier
__device__ __forceinline__ void load_cs(const double* __restrict__ cs,
                                        const float* __restrict__ dtc, int H, int K,
                                        double* cs_s, float* dt_s) {
  const int t = threadIdx.x;
  if (t < K) {
    cs_s[t] = cs[t];
    dt_s[t] = __ldg(dtc + (long)t * H);
  }
}

// shared memory of the state sweep, in floats: cs, wsum, the q row sums of
// 4 warps (doubles), dt, exp(cs), a two-stage ring of C's and dy's rows,
// h- (N x 32)
constexpr int kStHead = 2 * (kMaxChunk + kWarps + 4 * kSw) + 2 * kMaxChunk;
constexpr int kStSmem = kStHead + 2 * kSw * (kS128 + kS32) + kMaxN * kS32;
static_assert(kStHead % 4 == 0, "16-byte aligned tiles");

// 2. The reverse sweep of dh, a CTA per (h, b, 32 columns of P). Warp w owns
// dh's rows 16 w.. (warps past N idle in the products). Per chunk: the dh
// entering it from the right to dstates, exp(cs_last) sum(h- * dh) to hterm;
// then over blocks of 32 tokens: q = C . h- and the inbound dcs term
// exp(cs_i) dy_i . q_i, and dh <- exp(cs_last) dh + sum_i exp(cs_i) C_i (x) dy_i.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_state_kernel(const float* __restrict__ Cm, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ states,
                     const float* __restrict__ dy, const float* __restrict__ dh_final,
                     float* __restrict__ scratch, int L, int H, int P, int N, int K) {
  extern __shared__ float4 smem4[];
  double* cs_s = reinterpret_cast<double*>(smem4);
  double* wsum = cs_s + kMaxChunk;
  double* red = wsum + kWarps;                   // [4][kSw]
  float* dt_s = reinterpret_cast<float*>(red + 4 * kSw);
  float* ecs_s = dt_s + kMaxChunk;
  float* cst = reinterpret_cast<float*>(smem4) + kStHead;   // [2][kSw][kS128]
  float* ys = cst + 2 * kSw * kS128;                         // [2][kSw][kS32]
  float* hs = ys + 2 * kSw * kS32;                           // [kMaxN][kS32]

  const int h = blockIdx.x, b = blockIdx.y, ph = blockIdx.z, p0 = ph * kPh;
  const int B = gridDim.y, nC = L / K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool owns = 16 * warp < N;
  const Layout lay(B, L, H, P, N, K);
  const float a = A[h];
  const long tokH = (long)H * P, bhl = (long)B * H * L, row = ((long)b * H + h) * L;
  const int pw = P - p0, nb = cdiv(K, kSw);
  const bool vec_n = N % 4 == 0, vec_p = P % 4 == 0;
  const int qm = warp >> 2, qn = warp & 3;       // q's 16 x 8 tile: rows 16 qm, columns 8 qn

  double dh[1][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 16 * warp + acc_row(0, e), p = acc_col(j, e);
      dh[0][j][e] = dh_final != nullptr && n < N && p < pw
                        ? dh_final[(((long)b * H + h) * N + n) * P + p0 + p]
                        : 0.0;
    }
  for (int c = nC - 1; c >= 0; --c) {
    const int c0 = c * K;
    const long st = (((long)b * nC + c) * H + h) * N * P;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * warp + acc_row(0, e), p = acc_col(j, e);
        if (n < N && p < pw)
          scratch[lay.dstates + st + (long)n * P + p0 + p] = static_cast<float>(dh[0][j][e]);
      }
    const float* Cc = Cm + ((long)b * L + c0) * N;
    const float* dyc = dy + ((long)b * L + c0) * tokH + (long)h * P + p0;
    stage<kMaxN, kPh, kS32>(hs, states + st + p0, P, N, pw, vec_p);
    stage<kSw, kMaxN, kS128>(cst, Cc, N, K, N, vec_n);
    stage<kSw, kPh, kS32>(ys, dyc, tokH, K, pw, vec_p);
    cp_commit();
    chunk_cs(dt + ((long)b * L + c0) * H + h, H, K, a, cs_s, dt_s, wsum);
    if (tid < nb * kSw) ecs_s[tid] = tid < K ? expf(static_cast<float>(cs_s[tid])) : 0.f;
    if (ph == 0 && tid < K) dplane(scratch, lay.cs)[row + c0 + tid] = cs_s[tid];
    const float e_last = expf(static_cast<float>(cs_s[K - 1]));
    cp_wait<0>();
    __syncthreads();
    double part = 0.0;
    if (owns) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 16 * warp + acc_row(0, e), p = acc_col(j, e);
          part += static_cast<double>(hs[n * kS32 + p]) * dh[0][j][e];
        }
    }
    double total;
    block_scan(part, wsum, total);
    if (tid == 0)
      dplane(scratch, lay.hterm)[(((long)ph * B + b) * H + h) * nC + c] = e_last * total;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[0][j][e] *= e_last;

    for (int s = 0; s < nb; ++s) {
      if (s + 1 < nb) {
        const int r0 = (s + 1) * kSw;
        stage<kSw, kMaxN, kS128>(cst + ((s + 1) & 1) * kSw * kS128, Cc + (long)r0 * N, N,
                                 K - r0, N, vec_n);
        stage<kSw, kPh, kS32>(ys + ((s + 1) & 1) * kSw * kS32, dyc + r0 * tokH, tokH, K - r0,
                              pw, vec_p);
      }
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const float* cb = cst + (s & 1) * kSw * kS128;
      const float* yb = ys + (s & 1) * kSw * kS32;
      double q[1][1][4];
      zero(q);
      mma_tile<1, 1, kS128, 1, kS32, 1>(q, cb + 16 * qm * kS128, hs + 8 * qn, round8(N));
      double r[2] = {0.0, 0.0};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[e >> 1] += q[0][0][e] * yb[(16 * qm + acc_row(0, e)) * kS32 + 8 * qn + acc_col(0, e)];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        r[k] += __shfl_xor_sync(kFull, r[k], 1);
        r[k] += __shfl_xor_sync(kFull, r[k], 2);
      }
      if (t == 0) {
        red[qn * kSw + 16 * qm + g] = r[0];
        red[qn * kSw + 16 * qm + g + 8] = r[1];
      }
      // A(n, i) = C[i][n] exp(cs_i), B(i, p) = dy[i][p]
      if (owns)
        mma_tile<1, 4, 1, kS128, kS32, 1, kScaleK>(dh, cb + 16 * warp, yb, kSw,
                                                   ecs_s + s * kSw);
      __syncthreads();
      if (tid < kSw && s * kSw + tid < K) {
        const int i = s * kSw + tid;
        dplane(scratch, lay.dcsin)[ph * bhl + row + c0 + i] =
            ecs_s[i] * (((red[tid] + red[kSw + tid]) + red[2 * kSw + tid]) + red[3 * kSw + tid]);
      }
    }
  }
}

// shared memory of the tile kernel, in floats: cs, the row sums of 4 warps,
// the column sums of 2 (doubles), dt, the column sums of dW G L of 2 warps,
// then a two-stage ring of dy's and x's rows
constexpr int kTiHead = 2 * (kMaxChunk + 4 * kT + 2 * kT) + kMaxChunk + 2 * kT;
constexpr int kTiSmem = kTiHead + 4 * kT * kS64;
static_assert(kTiHead % 4 == 0, "16-byte aligned tiles");

// 3. Score tile (ib, jb), jb <= ib, of one chunk, for each head of a group of
// kHG: dW = dy_i . x_j over P once; then for j <= i < K, L = exp(cs_i - cs_j),
// dG = dW L dt_j summed over the group's heads (in the accumulators' f64),
// S = dW G L dt_j (j < i) summed along rows (plane jb of rowS) and columns
// (plane ib of colS), dW G L along columns (plane ib of colD). Warp (wm, wn)
// owns rows 32 wm.., columns 16 wn.. of the tile. The heads' dy and x rows
// come through a two-stage ring.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_tile_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ dy, float* __restrict__ scratch, int L, int H,
                    int P, int N, int K) {
  extern __shared__ float4 smem4[];
  double* cs_s = reinterpret_cast<double*>(smem4);
  double* rred = cs_s + kMaxChunk;               // [4][kT]
  double* cred = rred + 4 * kT;                  // [2][kT]
  float* dt_s = reinterpret_cast<float*>(cred + 2 * kT);
  float* dred = dt_s + kMaxChunk;                // [2][kT]
  float* ring = reinterpret_cast<float*>(smem4) + kTiHead;  // [2][dy 64 x kS64, x 64 x kS64]

  int ib = 0;
  while ((ib + 1) * (ib + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ib;
  const int jb = blockIdx.x - ib * (ib + 1) / 2, i0 = ib * kT, j0 = jb * kT;
  const int nG = cdiv(H, kHG), c = blockIdx.y / nG, grp = blockIdx.y % nG, b = blockIdx.z;
  const int B = gridDim.z, nC = L / K, c0 = c * K;
  const int h0 = grp * kHG, h1 = min(H, h0 + kHG);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const Layout lay(B, L, H, P, N, K);
  const long tokH = (long)H * P, bhl = (long)B * H * L;
  const bool vec_p = P % 4 == 0;
  const float* Gc = scratch + lay.g + ((long)b * nC + c) * K * K;
  const float* dyc = dy + ((long)b * L + c0 + i0) * tokH;
  const float* xc = x + ((long)b * L + c0 + j0) * tokH;
  constexpr int kSlot = 2 * kT * kS64;

  double gs[2][2][4];
  zero(gs);
  float gl[2][2][4];                             // the tile's G (the same for every head)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 32 * wm + acc_row(mi, e), j = j0 + 16 * wn + acc_col(nj, e);
        gl[mi][nj][e] = i < K && j <= i ? __ldg(Gc + (long)i * K + j) : 0.f;
      }
  stage<kT, kMaxP, kS64>(ring, dyc + (long)h0 * P, tokH, K - i0, P, vec_p);
  stage<kT, kMaxP, kS64>(ring + kT * kS64, xc + (long)h0 * P, tokH, K - j0, P, vec_p);
  cp_commit();
  for (int h = h0; h < h1; ++h) {
    const int s = h - h0;
    if (h + 1 < h1) {
      float* nxt = ring + ((s + 1) & 1) * kSlot;
      stage<kT, kMaxP, kS64>(nxt, dyc + (long)(h + 1) * P, tokH, K - i0, P, vec_p);
      stage<kT, kMaxP, kS64>(nxt + kT * kS64, xc + (long)(h + 1) * P, tokH, K - j0, P, vec_p);
    }
    cp_commit();
    load_cs(dplane(scratch, lay.cs) + ((long)b * H + h) * L + c0,
            dt + ((long)b * L + c0) * H + h, H, K, cs_s, dt_s);
    cp_wait<1>();
    __syncthreads();
    const float* ys = ring + (s & 1) * kSlot;
    double dw[2][2][4];
    zero(dw);
    // dW(i, j) = sum_p dy[i][p] x[j][p]
    mma_tile<2, 2, kS64, 1, 1, kS64>(dw, ys + 32 * wm * kS64, ys + kT * kS64 + 16 * wn * kS64,
                                      round8(P));
    double srow[2][2] = {}, scol[2][2] = {};
    float dcol[2][2] = {};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 32 * wm + acc_row(mi, e), j = j0 + 16 * wn + acc_col(nj, e);
          if (i < K && j <= i) {
            const float lij = expf(fminf(static_cast<float>(cs_s[i] - cs_s[j]), 0.f));
            const float glv = gl[mi][nj][e] * lij;
            const float dwv = static_cast<float>(dw[mi][nj][e]);
            const float sv = j < i ? dwv * (glv * dt_s[j]) : 0.f;
            gs[mi][nj][e] += static_cast<double>(dwv * lij * dt_s[j]);
            srow[mi][e >> 1] += sv;
            scol[nj][e & 1] += sv;
            dcol[nj][e & 1] += dwv * glv;
          }
        }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        double v = srow[mi][hf];
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        if (t == 0) rred[wn * kT + 32 * wm + 16 * mi + 8 * hf + g] = v;
      }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int lo = 0; lo < 2; ++lo) {
        double v = scol[nj][lo];
        float d = dcol[nj][lo];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          v += __shfl_xor_sync(kFull, v, o);
          d += __shfl_xor_sync(kFull, d, o);
        }
        if (g == 0) {
          cred[wm * kT + 16 * wn + 8 * nj + 2 * t + lo] = v;
          dred[wm * kT + 16 * wn + 8 * nj + 2 * t + lo] = d;
        }
      }
    __syncthreads();
    const long row = ((long)b * H + h) * L + c0;
    if (tid < kT) {
      if (i0 + tid < K)
        dplane(scratch, lay.rowS)[jb * bhl + row + i0 + tid] =
            ((rred[tid] + rred[kT + tid]) + rred[2 * kT + tid]) + rred[3 * kT + tid];
    } else if (tid < 2 * kT) {
      const int q = tid - kT;
      if (j0 + q < K) {
        dplane(scratch, lay.colS)[ib * bhl + row + j0 + q] = cred[q] + cred[kT + q];
        scratch[lay.colD + ib * bhl + row + j0 + q] = dred[q] + dred[kT + q];
      }
    }
    __syncthreads();
  }
  float* gp = scratch + lay.gsum + (((long)grp * B + b) * nC + c) * K * K;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 32 * wm + acc_row(mi, e), j = j0 + 16 * wn + acc_col(nj, e);
        if (i < K && j < K) gp[(long)i * K + j] = static_cast<float>(gs[mi][nj][e]);
      }
}

// shared memory of the dx kernel, in floats: cs, the u sums of 4 warps
// (doubles), dt, then the larger of two views: B's rows, dh and x's rows at
// the start, a two-stage ring of dy's rows and the W tile in the loop
constexpr int kDxHead = 2 * (kMaxChunk + 4 * kT) + kMaxChunk;
constexpr int kDxInit = kT * kS128 + kMaxN * kS64 + kT * kS64;
constexpr int kDxLoop = 3 * kT * kS64;
constexpr int kDxSmem = kDxHead + (kDxInit > kDxLoop ? kDxInit : kDxLoop);
static_assert(kDxHead % 4 == 0, "16-byte aligned tiles");

// 4. Column block jb (heaviest first), chunk, head, batch: z = B_j . dh (over
// N), u_j = x_j . z_j, dx_j = w_j z_j + sum_{i>=j} W_ij dy_i; and per token
// exp(cs_last - cs_j) u_j and w_j u_j. Warp (wm, wn) owns dx's rows 32 wm..,
// columns 16 wn..
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                  const float* __restrict__ dt, const float* __restrict__ dy,
                  float* __restrict__ dx, float* __restrict__ scratch, int L, int H, int P,
                  int N, int K) {
  extern __shared__ float4 smem4[];
  double* cs_s = reinterpret_cast<double*>(smem4);
  double* ured = cs_s + kMaxChunk;               // [4][kT]
  float* dt_s = reinterpret_cast<float*>(ured + 4 * kT);
  float* U = reinterpret_cast<float*>(smem4) + kDxHead;
  float* bs = U;                                 // start: B's rows [j][n]
  float* dhs = bs + kT * kS128;                  //        dh [n][p]
  float* xs = dhs + kMaxN * kS64;                //        x's rows [j][p]
  float* ys = U;                                 // loop: dy's rows [i][p], two stages
  float* ws = ys + 2 * kT * kS64;                //       W [i][j]

  const int jb = blockIdx.x, j0 = jb * kT, nT = cdiv(K, kT);
  const int c = blockIdx.y / H, h = blockIdx.y % H, b = blockIdx.z, nC = L / K, c0 = c * K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const Layout lay(gridDim.z, L, H, P, N, K);
  const long tokH = (long)H * P, plane = (long)gridDim.z * H * L;
  const bool vec_n = N % 4 == 0, vec_p = P % 4 == 0;
  const float* xc = x + ((long)b * L + c0) * tokH + (long)h * P;
  const float* dyc = dy + ((long)b * L + c0) * tokH + (long)h * P;
  const float* Gc = scratch + lay.g + ((long)b * nC + c) * K * K;

  stage<kT, kMaxN, kS128>(bs, Bm + ((long)b * L + c0 + j0) * N, N, K - j0, N, vec_n);
  stage<kMaxN, kMaxP, kS64>(dhs, scratch + lay.dstates + (((long)b * nC + c) * H + h) * N * P,
                            P, N, P, vec_p);
  stage<kT, kMaxP, kS64>(xs, xc + j0 * tokH, tokH, K - j0, P, vec_p);
  cp_commit();
  load_cs(dplane(scratch, lay.cs) + ((long)b * H + h) * L + c0,
          dt + ((long)b * L + c0) * H + h, H, K, cs_s, dt_s);
  cp_wait<0>();
  __syncthreads();
  const double cs_last = cs_s[K - 1];
  double acc[2][2][4];
  zero(acc);
  mma_tile<2, 2, kS128, 1, kS64, 1>(acc, bs + 32 * wm * kS128, dhs + 16 * wn, round8(N));
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 32 * wm + 16 * mi + 8 * hf + (lane >> 2);
      double v = 0.0;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int lo = 0; lo < 2; ++lo)
          v += acc[mi][nj][2 * hf + lo] *
               static_cast<double>(xs[r * kS64 + 16 * wn + 8 * nj + 2 * t + lo]);
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      if (t == 0) ured[wn * kT + r] = v;
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 32 * wm + acc_row(mi, e);
      const float wj = j < K ? dt_s[j] * expf(static_cast<float>(cs_last - cs_s[j])) : 0.f;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) acc[mi][nj][e] *= wj;
    }
  __syncthreads();
  if (tid < kT && j0 + tid < K) {
    const int j = j0 + tid;
    const double u = ((ured[tid] + ured[kT + tid]) + ured[2 * kT + tid]) + ured[3 * kT + tid];
    const float eo = expf(static_cast<float>(cs_last - cs_s[j]));
    const long v = ((long)b * H + h) * L + c0 + j;
    scratch[lay.vec + kEoU * plane + v] = static_cast<float>(eo * u);
    scratch[lay.vec + kWu * plane + v] = static_cast<float>(dt_s[j] * eo * u);
  }
  __syncthreads();                               // the start view is read

  stage<kT, kMaxP, kS64>(ys, dyc + j0 * tokH, tokH, K - j0, P, vec_p);
  cp_commit();
  float gv[kTileElems];
  g_regs(gv, Gc, j0, j0, K);
  for (int ib = jb; ib < nT; ++ib) {
    const int s = ib - jb;
    if (ib + 1 < nT) {
      const int r0 = (ib + 1) * kT;
      stage<kT, kMaxP, kS64>(ys + ((s + 1) & 1) * kT * kS64, dyc + r0 * tokH, tokH, K - r0, P,
                             vec_p);
    }
    cp_commit();
    w_tile(ws, gv, cs_s, dt_s, ib * kT, j0, K);
    if (ib + 1 < nT) g_regs(gv, Gc, (ib + 1) * kT, j0, K);
    cp_wait<1>();
    __syncthreads();
    // A(j, i) = W[i][j], B(i, p) = dy[i][p]
    mma_tile<2, 2, 1, kS64, kS64, 1>(acc, ws + 32 * wm, ys + (s & 1) * kT * kS64 + 16 * wn, kT);
    __syncthreads();
  }

  float* dxo = dx + ((long)b * L + c0) * tokH + (long)h * P;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 32 * wm + acc_row(mi, e), p = 16 * wn + acc_col(nj, e);
        if (j < K && p < P) dxo[(long)j * tokH + p] = static_cast<float>(acc[mi][nj][e]);
      }
}

// 5. dcs per chunk, R_t = sum_{i>=t} dcs_i, ddt = direct + a R, and
// sum_t dt_t R_t over the chunks of one (b, h) into dA's partial; a CTA per
// (h, b), a thread a token. Every partial plane is summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  float* __restrict__ ddt, float* __restrict__ scratch, int L, int H, int P,
                  int N, int K) {
  __shared__ double wsum[kWarps], dcs_s[kMaxChunk];
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y, nC = L / K, t = threadIdx.x;
  const int nT = cdiv(K, kT), nPh = cdiv(P, kPh), bt = t / kT;
  const Layout lay(B, L, H, P, N, K);
  const long plane = (long)B * H * L, row = ((long)b * H + h) * L;
  const double* rowS = dplane(scratch, lay.rowS);
  const double* colS = dplane(scratch, lay.colS);
  const double* dcsin = dplane(scratch, lay.dcsin);
  const double* hterm = dplane(scratch, lay.hterm);
  const double a = A[h];
  double dA = 0.0;
  for (int c = 0; c < nC; ++c) {
    const long v = row + (long)c * K + t;
    const float* vec = scratch + lay.vec;
    double total;
    block_scan(t < K ? static_cast<double>(vec[kWu * plane + v]) : 0.0, wsum, total);
    float direct = 0.f;
    if (t < K) {
      double d = 0.0;
      for (int k = 0; k <= bt; ++k) d += rowS[k * plane + v];
      for (int k = 0; k < nPh; ++k) d += dcsin[k * plane + v];
      for (int k = bt; k < nT; ++k) {
        d -= colS[k * plane + v];
        direct += scratch[lay.colD + k * plane + v];
      }
      d -= static_cast<double>(vec[kWu * plane + v]);
      direct += vec[kEoU * plane + v];
      if (t == K - 1) {
        d += total;
        for (int k = 0; k < nPh; ++k) d += hterm[(((long)k * B + b) * H + h) * nC + c];
      }
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
      ddt[l] = direct + static_cast<float>(a * R);
      part = static_cast<double>(dt[l]) * R;
    }
    block_scan(part, wsum, total);
    dA += total;
  }
  if (t == 0) dplane(scratch, lay.dA)[(long)b * H + h] = dA;
}

// shared memory of the dB/dC kernel, in floats: the row scales of two
// stages, then a two-stage ring of A's 64 rows and B's 64 rows
constexpr int kDbcSmem = 2 * kT + 4 * kT * kS64;

// 6. Rows rb of dC (blockIdx.y 0) or dB (1), columns n0..n0 + NS, of one
// (b, chunk): the summed dG's products, sum_{j<=i} dGs_ij B_j (dC) or
// sum_{i>=j} dGs_ij C_i (dB), dGs summed over the groups of heads as it is
// staged; then over every head the inbound (exp(cs_i) dy_i) . h- (dC) or the
// outbound (w_j x_j) . dh (dB). A two-stage ring over the tiles, then the
// heads. CTA (0, 0, 0) also sums dA's partials over batch.
// Two CTAs an SM (128 registers) for the 64-column instance, the measured
// faster; the 16-column one spills 400 bytes at 128 and keeps one.
template <int NS>
__global__ void __launch_bounds__(kThreads, NS == 64 ? 2 : 1)
ssd_bwd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dt,
                   const float* __restrict__ states, const float* __restrict__ dy,
                   float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ dA,
                   const float* __restrict__ scratch, int B, int L, int H, int P, int N,
                   int K) {
  constexpr int WM = NS >= 32 ? 2 : 4, WN = kWarps / WM;
  constexpr int MI = kT / (16 * WM), NI = NS / (8 * WN);
  static_assert(MI >= 1 && NI >= 1 && NS <= 64, "warp tiles");
  extern __shared__ float4 smem4[];
  float* sc_s = reinterpret_cast<float*>(smem4);           // [2][kT]
  float* as_ = sc_s + 2 * kT;                              // [2][kT][kS64]
  float* bs_ = as_ + 2 * kT * kS64;                        // [2][kT][kS64]

  const int nNs = cdiv(N, NS), rb = blockIdx.x / nNs, n0 = blockIdx.x % nNs * NS;
  const bool is_db = blockIdx.y == 1;
  const int nC = L / K, b = blockIdx.z / nC, c = blockIdx.z % nC, c0 = c * K, r0 = rb * kT;
  const int nT = cdiv(K, kT), nG = cdiv(H, kHG);
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp / WN, wn = warp % WN;
  const Layout lay(B, L, H, P, N, K);
  const long tokH = (long)H * P;
  const bool vec_n = N % 4 == 0, vec_p = P % 4 == 0;
  const int ntile = is_db ? nT - rb : rb + 1, steps = ntile + H;
  const double* cs64 = reinterpret_cast<const double*>(scratch + lay.cs);

  auto issue = [&](int step, int slot) {
    float* as = as_ + slot * kT * kS64;
    float* bs = bs_ + slot * kT * kS64;
    if (step < ntile) {
      const int kb = is_db ? rb + step : step;               // the other block
      const int ti = is_db ? kb : rb, tj = is_db ? rb : kb;  // the dG tile (i, j)
      const float* gp = scratch + lay.gsum + ((long)b * nC + c) * K * K;
      const long gstride = (long)B * nC * K * K;
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int r = e >> 6, q = e & 63, i = ti * kT + r, j = tj * kT + q;
        double v = 0.0;
        if (i < K && j < K)
          for (int gi = 0; gi < nG; ++gi) v += gp[gi * gstride + (long)i * K + j];
        as[r * kS64 + q] = static_cast<float>(v);
      }
      const float* src = (is_db ? Cm : Bm) + ((long)b * L + c0 + kb * kT) * N + n0;
      stage<kT, NS, kS64>(bs, src, N, K - kb * kT, N - n0, vec_n);
    } else {
      const int h = step - ntile;
      const float* src = (is_db ? x : dy) + ((long)b * L + c0 + r0) * tokH + (long)h * P;
      stage<kT, kMaxP, kS64>(as, src, tokH, K - r0, P, vec_p);
      const float* hsrc = (is_db ? scratch + lay.dstates : states) +
                          ((((long)b * nC + c) * H + h) * N + n0) * P;
      stage<NS, kMaxP, kS64>(bs, hsrc, P, N - n0, P, vec_p);
      if (tid < kT) {
        const int i = r0 + tid;
        const long cr = ((long)b * H + h) * L + c0;
        float sv = 0.f;
        if (i < K) {
          const double ci = cs64[cr + i];
          sv = is_db ? __ldg(dt + ((long)b * L + c0 + i) * H + h) *
                           expf(static_cast<float>(cs64[cr + K - 1] - ci))
                     : expf(static_cast<float>(ci));
        }
        sc_s[slot * kT + tid] = sv;
      }
    }
  };

  double acc[MI][NI][4];
  zero(acc);
  issue(0, 0);
  cp_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1, (s + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* as = as_ + (s & 1) * kT * kS64;
    const float* bs = bs_ + (s & 1) * kT * kS64;
    if (s < ntile) {
      if (is_db)   // A(j, i) = dGs[i][j], B(i, n) = C[i][n]
        mma_tile<MI, NI, 1, kS64, kS64, 1>(acc, as + 16 * MI * wm, bs + 8 * NI * wn, kT);
      else         // A(i, j) = dGs[i][j], B(j, n) = B[j][n]
        mma_tile<MI, NI, kS64, 1, kS64, 1>(acc, as + 16 * MI * wm * kS64, bs + 8 * NI * wn, kT);
    } else {       // A(r, p) = scale_r (dy or x)[r][p], B(p, n) = (h- or dh)[n][p]
      mma_tile<MI, NI, kS64, 1, 1, kS64, kScaleRows>(acc, as + 16 * MI * wm * kS64,
                                                      bs + 8 * NI * wn * kS64, round8(P),
                                                      sc_s + (s & 1) * kT + 16 * MI * wm);
    }
    __syncthreads();
  }

  float* out = (is_db ? dB : dC) + ((long)b * L + c0) * N;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 16 * MI * wm + acc_row(i, e), n = n0 + 8 * NI * wn + acc_col(j, e);
        if (r < K && n < N) out[(long)r * N + n] = static_cast<float>(acc[i][j][e]);
      }
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
    const double* part = reinterpret_cast<const double*>(scratch + lay.dA);
    for (int hh = tid; hh < H; hh += kThreads) {
      double s = 0.0;
      for (int bb = 0; bb < B; ++bb) s += part[(long)bb * H + hh];
      dA[hh] = static_cast<float>(s);
    }
  }
}

// state columns a dB/dC CTA owns: sized to N, so N 16 runs no padding to 64
int dbc_slice(int N) { return N <= 16 ? 16 : 64; }

template <int NS>
cudaError_t launch_dbc(const float* x, const float* Bm, const float* Cm, const float* dt,
                       const float* states, const float* dy, float* dB, float* dC, float* dA,
                       const float* sc, int B, int L, int H, int P, int N, int K,
                       cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_dbc_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDbcSmem * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return attr;
  const int nT = cdiv(K, kT);
  ssd_bwd_dbc_kernel<NS><<<dim3(nT * cdiv(N, NS), 2, B * (L / K)), kThreads,
                           kDbcSmem * sizeof(float), s>>>(x, Bm, Cm, dt, states, dy, dB, dC,
                                                          dA, sc, B, L, H, P, N, K);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch ssd_scan_bwd needs at these shapes (0 if L % chunk != 0).
extern "C" long long ssd_scan_bwd_scratch_floats(int B, int L, int H, int P, int N,
                                                 int chunk) {
  if (chunk <= 0 || L % chunk != 0) return 0;
  return Layout(B, L, H, P, N, chunk).total;
}

// dh_final may be null (a zero cotangent). scratch holds
// ssd_scan_bwd_scratch_floats(...) floats, 16-byte aligned. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int ssd_scan_bwd(const void* x, const void* Bm, const void* Cm, const void* dt,
                            const void* A, const void* states, const void* dy,
                            const void* dh_final, void* dx, void* dB, void* dC, void* ddt,
                            void* dA, void* scratch, int B, int L, int H, int P, int N,
                            int chunk, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || L <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      L % chunk != 0 || (long)(L / chunk) * H > 65535 || (long)B * (L / chunk) > 65535 ||
      H > 65535 || N <= 0 || N > kMaxN || P <= 0 || P > kMaxP || scratch == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attrs[] = {
      cudaFuncSetAttribute(ssd_bwd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kStSmem * static_cast<int>(sizeof(float))),
      cudaFuncSetAttribute(ssd_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kTiSmem * static_cast<int>(sizeof(float))),
      cudaFuncSetAttribute(ssd_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDxSmem * static_cast<int>(sizeof(float)))};
  for (const cudaError_t a : attrs)
    if (a != cudaSuccess) return static_cast<int>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nC = L / chunk, nT = cdiv(chunk, kT);
  const float *fx = static_cast<const float*>(x), *fB = static_cast<const float*>(Bm),
              *fC = static_cast<const float*>(Cm), *fdt = static_cast<const float*>(dt),
              *fA = static_cast<const float*>(A), *fst = static_cast<const float*>(states),
              *fdy = static_cast<const float*>(dy), *fdh = static_cast<const float*>(dh_final);
  float* sc = static_cast<float*>(scratch);
  cudaError_t e;
  const Layout lay(B, L, H, P, N, chunk);
  g_kernel<<<dim3(nT * nT, nC, B), kThreads, 0, s>>>(fB, fC, sc + lay.g, L, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_state_kernel<<<dim3(H, B, cdiv(P, kPh)), kThreads, kStSmem * sizeof(float), s>>>(
      fC, fdt, fA, fst, fdy, fdh, sc, L, H, P, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_tile_kernel<<<dim3(nT * (nT + 1) / 2, nC * cdiv(H, kHG), B), kThreads,
                        kTiSmem * sizeof(float), s>>>(fx, fdt, fdy, sc, L, H, P, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dx_kernel<<<dim3(nT, nC * H, B), kThreads, kDxSmem * sizeof(float), s>>>(
      fx, fB, fdt, fdy, static_cast<float*>(dx), sc, L, H, P, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dt_kernel<<<dim3(H, B), kThreads, 0, s>>>(fdt, fA, static_cast<float*>(ddt), sc, L,
                                                    H, P, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  e = dbc_slice(N) == 16
          ? launch_dbc<16>(fx, fB, fC, fdt, fst, fdy, static_cast<float*>(dB),
                           static_cast<float*>(dC), static_cast<float*>(dA), sc, B, L, H, P, N,
                           chunk, s)
          : launch_dbc<64>(fx, fB, fC, fdt, fst, fdy, static_cast<float*>(dB),
                           static_cast<float*>(dC), static_cast<float*>(dA), sc, B, L, H, P, N,
                           chunk, s);
  return static_cast<int>(e);
}
