// Flash attention backward for Hopper (sm_90a).
//
// Replaces autodiff of the reference's flash_attention_jnp
// (src/repro/models/attention.py:65): the TPU side has no backward kernel,
// and the reference trains through attention_train -> flash_attention_jnp
// (:201 and :65), which JAX differentiates. This is the gradient of the
// forward in flash_attention.cu, from what that forward saves: q, k, v, o
// and each query row's log-sum-exp (natural log) of its scaled scores. Same
// layouts and masks as the forward: q, o, dO, dq (B, Sq, H, D); k, v, dk, dv
// (B, Skv, Kh, D); head h reads KV head h / G (G = H / Kh); query row i sits
// at position i + Skv - Sq; causal keeps kv <= q, a window keeps
// kv > q - window, kv >= Skv is masked. With s = scale * q . k:
//
//   P  = exp(s - LSE)                (recomputed, never stored)
//   dV = P^T dO           dP = dO V^T          Delta = rowsum(dO * O)
//   dS = P * (dP - Delta) dQ = scale * dS K     dK = scale * dS^T Q
//
// dK and dV sum over the G query heads of their KV head. Three launches:
// 1. delta: Delta (B, H, Sq) f32, a group of lanes a query row;
// 2. dkdv: one CTA per (KV block of 64 rows, KV head, batch). It walks the
//    G heads and, for each, the query blocks that can see its KV block (the
//    forward's causal and window skips, seen from the key side), recomputes
//    S and dP, and accumulates dK and dV in f32 registers; each is written
//    once;
// 3. dq: one CTA per (query block of 64 rows, head, batch). It walks the KV
//    blocks its rows can see and accumulates dQ in f32 registers.
// No atomics: every output element is summed by one thread, or by a fixed
// set of threads added in a fixed order, so two runs on the same inputs
// give the same bits (a checkpoint resume reproduces uninterrupted training
// exactly). The price is S and dP computed twice, seven products a tile pair
// instead of five. Both grids put the block index that sets a CTA's work in
// their slowest dimension, heaviest first (under a causal mask: the first
// KV block, the last query block), so the long walks start first.
//
// Bound on this card: at the training shape (B 8, S 512, H 12, Kh 4, D 64,
// bf16, causal) bytes: q, k, v, o, dO, LSE, Delta read and dq, dk, dv
// written once are 34.0 MB, 10.1 us at 3.35 TB/s, against the five
// products' 10 * D flops a visible (query, key) pair, 8.07 GFLOP, 8.2 us on
// the bf16 tensor cores. Seven products are 11.3 GFLOP. The kernels are far
// from either: every warp reads each staged B tile from shared memory
// itself, and a warp's chain of ldmatrix, mma.sync, exp2 and barriers is
// latency-bound at 8 (dkdv) and 12 (dq) warps an SM (PERF.md section 6).
//
// bf16 (the training path): tensor cores, mma.sync.m16n8k16 bf16 -> f32.
// - Tiles are staged as bf16 with 16-byte cp.async into rows padded by 16
//   bytes (D + 8 elements), so the 8 rows an ldmatrix reads fall in 8
//   distinct bank groups. The walked tiles go through a 2-stage ring: the
//   next tiles' copy runs while the current ones compute (dkdv: q and dO
//   with their 64 LSE and Delta values, 4-byte copies; dq: K and V).
// - dkdv: each warp owns 16 keys and computes the transposes, S^T = K Q^T
//   and dP^T = V dO^T (q and dO rows are the B operand, read with plain
//   ldmatrix as the forward reads K). P^T and dS^T then sit in the
//   accumulator layout that, packed to bf16, is the A operand of
//   dV += P^T dO and dK += dS^T Q (dO and q through ldmatrix.trans), the
//   move the forward makes for P V. A lane's columns are queries, so it
//   reads their LSE and Delta from the staged arrays.
// - dkdv has 8 warps. Up to D 128 two groups of four split the walk (group
//   w takes tiles w, w + 2, ...: a step stages two tiles), which halves the
//   longest CTA's chain of tiles; at the end group 1 hands its sums to
//   group 0 through shared memory, which adds them: the same order on every
//   run. At D 192 (MLA) the two groups split dK and dV's columns instead,
//   each computing the full S^T and dP^T of its keys (the S and dP products
//   run twice there), so a thread holds 96 accumulators, not 192.
// - dq: each warp owns 16 queries: S = q K^T and dP = dO V^T (K, V rows as
//   B), then dS is the A operand of dQ += dS K (K through ldmatrix.trans);
//   the lane's two rows keep their LSE and Delta in registers.
// - Softmax in log2 units: P = 2^(s * scale * log2 e - LSE * log2 e), one
//   ex2.approx. Masks are applied only where a causal diagonal, a window
//   edge or a ragged end crosses a warp's slice of the tile, and a warp
//   skips a slice that no pair of it can see.
// - P and dS are rounded to bf16 for the products, as the forward rounds P
//   before P V; every sum stays in f32 and each output is rounded once.
// - Registers: a dkdv warp holds 16 x D of dK and of dV in f32, D / 2
//   registers each a thread (96 at D 192 with the column split). Scores are
//   taken in chunks, 64 or 32 queries (dkdv) and 64 or 32 keys (dq), and up
//   to D 64 the A fragments (K, V in dkdv; q, dO in dq) stay in registers,
//   else they are read from shared memory on each use. No instance spills
//   (ptxas -v, kept beside the library).
// wgmma and TMA are left for later: the recompute of S and dP and the
// 16-row tiles a warp owns fit mma.sync, while wgmma's 64-row warpgroup
// tiles need another ownership of dK and dV (a warpgroup a key block, dS
// through shared memory).
//
// f32 (off the training path: the f32 copies of train_grads and the tests;
// their 2e-5 tolerance rules out TF32, as for the forward): the CUDA cores.
// q, k, v, dO are staged as f32 (rows padded to D + 1 floats) and every
// product runs in f32 from 4 x 4 register tiles (256 threads as 16 x 16).
// At D 192 a CTA takes 231,424 bytes of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 64;         // query and KV rows a tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Mask {
  int Sq, Skv, offset, causal, window;
  __device__ __forceinline__ bool ok(int i, int j) const {   // query row i, key j
    const int qpos = i + offset;
    bool ok = i < Sq && j < Skv;
    if (causal) ok = ok && j <= qpos;
    if (window > 0) ok = ok && j > qpos - window;
    return ok;
  }
};

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;      // 16 x 16
constexpr int kPS = kBlock + 1;    // padded row of a 64 x 64 score tile

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 1; }

template <int D>
constexpr int smem_bytes() {       // four 64 x D tiles, two score tiles, LSE and Delta
  return (4 * kBlock * row_stride<D>() + 2 * kBlock * kPS + 2 * kBlock) *
         static_cast<int>(sizeof(float));
}

// rows x D f32 from device memory (row stride `stride` elements) into a
// shared tile with padded rows; rows >= `valid` are zero. 16-byte loads.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, long stride, int valid) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kBlock * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks * 4;
    float* d = dst + r * row_stride<D>() + c;
    const float4 x = r < valid ? *reinterpret_cast<const float4*>(src + r * stride + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// S = q_s . k_s^T and dP = do_s . v_s^T for the thread's 4 x 4 elements
template <int D>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s, const float* k_s,
                                       const float* v_s, int ty, int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int kS = row_stride<D>();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qa[r] = q_s[(ty + 16 * r) * kS + d];
      da[r] = do_s[(ty + 16 * r) * kS + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kb[c] = k_s[(tx + 16 * c) * kS + d];
      vb[c] = v_s[(tx + 16 * c) * kS + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
        dp[r][c] = fmaf(da[r], vb[c], dp[r][c]);
      }
  }
}

// P and dS of the tile from S and dP: rows i0 + ty + 16 r (queries), columns
// j0 + tx + 16 c (keys); masked pairs are exactly 0
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4], const float* lse_s,
                                      const float* delta_s, const Mask& mask, int i0, int j0,
                                      int ty, int tx, float scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const float p = mask.ok(i0 + i, j0 + j) ? expf(s[r][c] * scale - lse_s[i]) : 0.f;
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - delta_s[i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
                      int Kh, int causal, int window, float scale) {
  constexpr int kS = row_stride<D>();
  constexpr int kC = D / 16;                     // d columns a thread owns
  extern __shared__ float smem[];
  float* k_s = smem;                             // 64 x kS
  float* v_s = k_s + kBlock * kS;
  float* q_s = v_s + kBlock * kS;
  float* do_s = q_s + kBlock * kS;
  float* p_s = do_s + kBlock * kS;               // 64 x kPS, [query][key]
  float* ds_s = p_s + kBlock * kPS;
  float* lse_s = ds_s + kBlock * kPS;            // 64
  float* delta_s = lse_s + kBlock;

  const int k0 = blockIdx.x * kBlock, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int offset = Skv - Sq;
  const Mask mask{Sq, Skv, offset, causal, window};

  const long kv_stride = (long)Kh * D, q_stride = (long)H * D;
  stage<D>(k_s, k + ((long)b * Skv * Kh + (long)k0 * Kh + kh) * D, kv_stride, Skv - k0);
  stage<D>(v_s, v + ((long)b * Skv * Kh + (long)k0 * Kh + kh) * D, kv_stride, Skv - k0);

  // query rows that can see a key of this block: causal needs i + offset >=
  // k0; a window needs i + offset < last key + window
  const int last_k = min(k0 + kBlock, Skv) - 1;
  const int i_lo = causal ? max(0, k0 - offset) : 0;
  const int i_hi = window > 0 ? min(Sq, last_k + window - offset) : Sq;

  float acc_k[4][kC], acc_v[4][kC];              // rows ty + 16 r, columns tx + 16 c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int i0 = i_lo / kBlock * kBlock; i0 < i_hi; i0 += kBlock) {
      __syncthreads();                           // the last tile's readers are done
      stage<D>(q_s, q + (((long)b * Sq + i0) * H + h) * D, q_stride, Sq - i0);
      stage<D>(do_s, dout + (((long)b * Sq + i0) * H + h) * D, q_stride, Sq - i0);
      for (int i = threadIdx.x; i < kBlock; i += kThreads) {
        const bool in = i0 + i < Sq;
        lse_s[i] = in ? lse[((long)b * H + h) * Sq + i0 + i] : 0.f;
        delta_s[i] = in ? delta[((long)b * H + h) * Sq + i0 + i] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      scores<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
      probs(s, dp, lse_s, delta_s, mask, i0, k0, ty, tx, scale);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p_s[(ty + 16 * r) * kPS + tx + 16 * c] = s[r][c];
          ds_s[(ty + 16 * r) * kPS + tx + 16 * c] = dp[r][c];
        }
      __syncthreads();

      // dV[j] += sum_i P[i][j] dO[i], dK[j] += sum_i dS[i][j] Q[i]; keys j = ty + 16 r
#pragma unroll 4
      for (int i = 0; i < kBlock; ++i) {
        float pj[4], sj[4], dov[kC], qv[kC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pj[r] = p_s[i * kPS + ty + 16 * r];
          sj[r] = ds_s[i * kPS + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          dov[c] = do_s[i * kS + tx + 16 * c];
          qv[c] = q_s[i * kS + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            acc_v[r][c] = fmaf(pj[r], dov[c], acc_v[r][c]);
            acc_k[r][c] = fmaf(sj[r], qv[c], acc_k[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= Skv) continue;
    const long base = (((long)b * Skv + j) * Kh + kh) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dk[base + tx + 16 * c] = acc_k[r][c] * scale;
      dv[base + tx + 16 * c] = acc_v[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Skv, int H, int Kh, int causal,
                    int window, float scale) {
  constexpr int kS = row_stride<D>();
  constexpr int kC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBlock * kS;
  float* k_s = do_s + kBlock * kS;
  float* v_s = k_s + kBlock * kS;
  float* ds_s = v_s + kBlock * kS;               // 64 x kPS, [query][key]
  float* lse_s = ds_s + 2 * kBlock * kPS;
  float* delta_s = lse_s + kBlock;

  const int i0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int offset = Skv - Sq;
  const Mask mask{Sq, Skv, offset, causal, window};

  const long kv_stride = (long)Kh * D, q_stride = (long)H * D;
  stage<D>(q_s, q + (((long)b * Sq + i0) * H + h) * D, q_stride, Sq - i0);
  stage<D>(do_s, dout + (((long)b * Sq + i0) * H + h) * D, q_stride, Sq - i0);
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const bool in = i0 + i < Sq;
    lse_s[i] = in ? lse[((long)b * H + h) * Sq + i0 + i] : 0.f;
    delta_s[i] = in ? delta[((long)b * H + h) * Sq + i0 + i] : 0.f;
  }

  // the forward's live KV range for these rows
  const int first_q = i0 + offset;
  const int last_q = min(i0 + kBlock, Sq) - 1 + offset;
  const int kv_end = causal ? min(Skv, last_q + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, first_q - window + 1) / kBlock * kBlock : 0;

  float acc[4][kC];                              // rows ty + 16 r, columns tx + 16 c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;

  for (int j0 = kv_begin; j0 < kv_end; j0 += kBlock) {
    __syncthreads();
    stage<D>(k_s, k + ((long)b * Skv * Kh + (long)j0 * Kh + kh) * D, kv_stride, Skv - j0);
    stage<D>(v_s, v + ((long)b * Skv * Kh + (long)j0 * Kh + kh) * D, kv_stride, Skv - j0);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
    probs(s, dp, lse_s, delta_s, mask, i0, j0, ty, tx, scale);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) ds_s[(ty + 16 * r) * kPS + tx + 16 * c] = dp[r][c];
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] K[j]; queries i = ty + 16 r
#pragma unroll 2
    for (int j = 0; j < kBlock; ++j) {
      float si[4], kv[kC];
#pragma unroll
      for (int r = 0; r < 4; ++r) si[r] = ds_s[(ty + 16 * r) * kPS + j];
#pragma unroll
      for (int c = 0; c < kC; ++c) kv[c] = k_s[j * kS + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[r][c] = fmaf(si[r], kv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= Sq) continue;
    const long base = (((long)b * Sq + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) dq[base + tx + 16 * c] = acc[r][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (helpers as in flash_attention.cu's bf16 path)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;                      // a warp owns 16 rows of a 64-row block
constexpr int kStages = 2;                       // ring of the walked tiles

// bf16 elements of a shared row: D plus 16 bytes of padding
template <int D>
__host__ __device__ constexpr int tc_stride() { return D + 8; }

// Per head dim: how dkdv's eight warps share a key block, and the tiles
template <int D>
struct Tc {
  static constexpr int kSplit = D > 128 ? 2 : 1;      // warp groups splitting the columns
  static constexpr int kWalk = 2 / kSplit;            // warp groups splitting the walk
  static constexpr int kKvThreads = 32 * kTcWarps * kSplit * kWalk;
  static constexpr int kCols = D / kSplit;            // dK, dV columns a warp owns
  static constexpr int kChunk = D >= 128 ? 32 : 64;   // queries a dkdv warp scores at once
  static constexpr int kChunkK = D >= 64 ? 32 : 64;   // keys a dq warp scores at once
  static constexpr bool kKeepA = D <= 64;             // K, V (dkdv) or q, dO (dq) fragments
                                                      // held in registers
  static constexpr int kTile = kBlock * tc_stride<D>() * 2;   // bytes of a 64-row tile
  // dkdv: K, V and a ring of kWalk q, dO tiles with their LSE and Delta a stage
  static constexpr int kSmemKv =
      (2 + 2 * kStages * kWalk) * kTile + kStages * kWalk * 2 * kBlock * 4;
  static constexpr int kSmemQ = 6 * kTile;            // dq: q, dO and a ring of K, V
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one SFU instruction; P is rounded to bf16 for the products
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 64 x D bf16 rows from device memory (row stride `stride` elements) into a
// padded shared tile, 16-byte copies by `kN` threads; rows >= `valid` are
// zero-filled
template <int D, int kN>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long stride, int valid) {
  constexpr int kChunks = D / 8;                 // 16-byte chunks a row
  for (int e = threadIdx.x; e < kBlock * kChunks; e += kN) {
    const int r = e / kChunks, c = e % kChunks * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * tc_stride<D>() + c, ok ? src + r * stride + c : src, ok);
  }
}

// 64 f32 values (LSE or Delta of a query block) into shared memory, one a
// thread for t in 0..63; values >= `valid` are zero-filled
__device__ __forceinline__ void stage_row(float* dst, const float* src, int valid, int t) {
  if (t >= 0 && t < kBlock) cp_async4(dst + t, t < valid ? src + t : src, t < valid);
}

// Fragment addresses in a padded tile (stride kS). A operand (16 rows from
// `row`, k step kk) read plainly; B operand whose rows are its n index (rows
// `row` + 16 np, two n-tiles) read plainly; B operand whose rows are its k
// index (k step kk from `row`, columns `col` + 16 dp, two n-tiles) read
// with ldmatrix.trans
template <int kS>
__device__ __forceinline__ int a_at(int row, int kk, int lane) {
  return (row + (lane & 15)) * kS + kk * 16 + (lane >> 4) * 8;
}
template <int kS>
__device__ __forceinline__ int b_rows_n(int row, int kk, int lane) {
  return (row + (lane & 7) + (lane >> 4) * 8) * kS + kk * 16 + ((lane >> 3) & 1) * 8;
}
template <int kS>
__device__ __forceinline__ int b_rows_k(int row, int col, int lane) {
  return (row + (lane & 7) + ((lane >> 3) & 1) * 8) * kS + col + (lane >> 4) * 8;
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::kKvThreads)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int Sq, int Skv, int H, int Kh, int causal, int window,
                           float scale, float scale_log2) {
  using C = Tc<D>;
  constexpr int kS = tc_stride<D>();
  constexpr int kDK = D / 16;                    // k steps of S^T and dP^T
  constexpr int kNQ = C::kChunk / 8;             // n-tiles of a chunk's scores
  constexpr int kDN = C::kCols / 8;              // n-tiles of the warp's dK, dV
  constexpr int kSlots = kStages * C::kWalk;     // q, dO tiles in the ring
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_tc);   // 64 x kS
  __nv_bfloat16* v_s = k_s + kBlock * kS;                            // 64 x kS
  __nv_bfloat16* q_s = v_s + kBlock * kS;                            // kSlots x 64 x kS
  __nv_bfloat16* do_s = q_s + kSlots * kBlock * kS;                  // kSlots x 64 x kS
  float* lse_s = reinterpret_cast<float*>(do_s + kSlots * kBlock * kS);   // kSlots x 64
  float* delta_s = lse_s + kSlots * kBlock;

  // key blocks in the slowest grid dimension: under a causal mask the first
  // sees every query block, so the heaviest CTAs start first
  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kBlock;
  const int G = H / Kh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw = warp % kTcWarps;                            // 16 keys
  const int col0 = warp / kTcWarps % C::kSplit * C::kCols;   // dK, dV columns
  const int walk = warp / (kTcWarps * C::kSplit);            // tiles walk, walk + kWalk, ...
  const int g = lane >> 2, t = lane & 3;
  const int offset = Skv - Sq;
  const Mask mask{Sq, Skv, offset, causal, window};

  // query blocks that can see a key of this block (as the f32 kernel)
  const int last_k = min(k0 + kBlock, Skv) - 1;
  const int i_lo = causal ? max(0, k0 - offset) : 0;
  const int i_hi = window > 0 ? min(Sq, last_k + window - offset) : Sq;
  const int qb0 = i_lo / kBlock;
  const int n_qb = i_hi > qb0 * kBlock ? (i_hi - qb0 * kBlock + kBlock - 1) / kBlock : 0;
  const int n_tiles = G * n_qb;                  // tile it: head kh G + it / n_qb
  const int n_steps = (n_tiles + C::kWalk - 1) / C::kWalk;   // kWalk tiles a step

  const long q_stride = (long)H * D, kv_stride = (long)Kh * D;
  auto stage_step = [&](int step, int buf) {     // the step's tiles into stage buf
    for (int w = 0; w < C::kWalk; ++w) {
      const int it = step * C::kWalk + w, slot = buf * C::kWalk + w;
      if (it >= n_tiles) break;
      const int h = kh * G + it / n_qb, i0 = (qb0 + it % n_qb) * kBlock;
      const long row = ((long)b * Sq + i0) * H + h;
      stage_tile<D, C::kKvThreads>(q_s + slot * kBlock * kS, q + row * D, q_stride, Sq - i0);
      stage_tile<D, C::kKvThreads>(do_s + slot * kBlock * kS, dout + row * D, q_stride,
                                   Sq - i0);
      const long at = ((long)b * H + h) * Sq + i0;
      stage_row(lse_s + slot * kBlock, lse + at, Sq - i0, threadIdx.x);
      stage_row(delta_s + slot * kBlock, delta + at, Sq - i0,
                static_cast<int>(threadIdx.x) - kBlock);
    }
  };
  if (n_tiles > 0) {                             // else dK = dV = 0
    const long kv_at = ((long)b * Skv + k0) * Kh + kh;
    stage_tile<D, C::kKvThreads>(k_s, k + kv_at * D, kv_stride, Skv - k0);
    stage_tile<D, C::kKvThreads>(v_s, v + kv_at * D, kv_stride, Skv - k0);
    stage_step(0, 0);
  }
  cp_async_commit();

  uint32_t kf[C::kKeepA ? kDK : 1][4], vf[C::kKeepA ? kDK : 1][4];
  float acc_k[kDN][4], acc_v[kDN][4];            // keys g, g + 8; columns col0 + 8 n + 2 t
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int ja = k0 + kw * 16, jb = ja + 15;     // the warp's keys
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step % kStages, it = step * C::kWalk + walk, slot = buf * C::kWalk + walk;
    if (step + 1 < n_steps) stage_step(step + 1, buf ^ 1);   // overlaps this step's math
    cp_async_commit();
    cp_async_wait_all_but_one();                 // step's tiles (and K, V) have landed
    __syncthreads();
    if constexpr (C::kKeepA) {
      if (step == 0) {
#pragma unroll
        for (int kk = 0; kk < kDK; ++kk) {
          ldmatrix_x4(kf[kk], k_s + a_at<kS>(kw * 16, kk, lane));
          ldmatrix_x4(vf[kk], v_s + a_at<kS>(kw * 16, kk, lane));
        }
      }
    }
    const int i0 = (qb0 + it % n_qb) * kBlock;
    const __nv_bfloat16* qt = q_s + slot * kBlock * kS;
    const __nv_bfloat16* dot = do_s + slot * kBlock * kS;
    const float* lse_t = lse_s + slot * kBlock;
    const float* delta_t = delta_s + slot * kBlock;

#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += C::kChunk) {
      const int qa = i0 + c0, qb = qa + C::kChunk - 1;    // the chunk's query rows
      const int pa = qa + offset, pb = qb + offset;       // and their positions
      const bool live = it < n_tiles && qa < Sq && ja < Skv && !(causal && ja > pb) &&
                        !(window > 0 && jb <= pa - window);
      if (!live) continue;

      // S^T = K q^T and dP^T = V dO^T: 16 keys x kChunk queries
      float st[kNQ][4], dpt[kNQ][4];
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (C::kKeepA) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ka[e] = kf[kk][e], va[e] = vf[kk][e];
        } else {
          ldmatrix_x4(ka, k_s + a_at<kS>(kw * 16, kk, lane));
          ldmatrix_x4(va, v_s + a_at<kS>(kw * 16, kk, lane));
        }
#pragma unroll
        for (int np = 0; np < kNQ / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, qt + b_rows_n<kS>(c0 + np * 16, kk, lane));
          mma_bf16(st[2 * np], ka, r[0], r[1]);
          mma_bf16(st[2 * np + 1], ka, r[2], r[3]);
          ldmatrix_x4(r, dot + b_rows_n<kS>(c0 + np * 16, kk, lane));
          mma_bf16(dpt[2 * np], va, r[0], r[1]);
          mma_bf16(dpt[2 * np + 1], va, r[2], r[3]);
        }
      }

      // P^T and dS^T in place; the lane's keys are rows g, g + 8 (e >> 1),
      // its queries columns 8 n + 2 t + (e & 1)
      const bool edge = qb >= Sq || jb >= Skv || (causal && jb > pa) ||
                        (window > 0 && ja <= pb - window);
#pragma unroll
      for (int n = 0; n < kNQ; ++n) {
        const int i = c0 + n * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + i);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + i);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
          float p = fast_exp2(fmaf(st[n][e], scale_log2, -l * kLog2e));
          if (edge && !mask.ok(i0 + i + (e & 1), ja + g + 8 * (e >> 1))) p = 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl);
        }
      }

      // dV += P^T dO and dK += dS^T q: two score n-tiles are one A fragment
      // of a 16-deep k step; dO and q rows are the k index (ldmatrix.trans)
#pragma unroll
      for (int kk = 0; kk < C::kChunk / 16; ++kk) {
        const uint32_t pa4[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                 pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                 pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                 pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t sa4[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                                 pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                                 pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                 pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kDN / 2; ++dp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, dot + b_rows_k<kS>(c0 + kk * 16, col0 + dp * 16, lane));
          mma_bf16(acc_v[2 * dp], pa4, r[0], r[1]);
          mma_bf16(acc_v[2 * dp + 1], pa4, r[2], r[3]);
          ldmatrix_x4_trans(r, qt + b_rows_k<kS>(c0 + kk * 16, col0 + dp * 16, lane));
          mma_bf16(acc_k[2 * dp], sa4, r[0], r[1]);
          mma_bf16(acc_k[2 * dp + 1], sa4, r[2], r[3]);
        }
      }
    }
    __syncthreads();                             // stage buf is free for step + 2
  }

  // walk groups above 0 hand their sums to group 0 through the ring, which
  // adds them in group order: the same order on every run
  if constexpr (C::kWalk > 1) {
    float* part = reinterpret_cast<float*>(q_s);   // 2 kDN 4 floats a thread a group
    constexpr int kGroup = 32 * kTcWarps * C::kSplit;
    const int tg = threadIdx.x % kGroup;
#pragma unroll 1
    for (int w = 1; w < C::kWalk; ++w) {
      if (walk == w) {
#pragma unroll
        for (int n = 0; n < kDN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            part[((2 * n) * 4 + e) * kGroup + tg] = acc_k[n][e];
            part[((2 * n + 1) * 4 + e) * kGroup + tg] = acc_v[n][e];
          }
      }
      __syncthreads();
      if (walk == 0) {
#pragma unroll
        for (int n = 0; n < kDN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc_k[n][e] += part[((2 * n) * 4 + e) * kGroup + tg];
            acc_v[n][e] += part[((2 * n + 1) * 4 + e) * kGroup + tg];
          }
      }
      __syncthreads();
    }
    if (walk != 0) return;
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = ja + g + 8 * rr;
    if (j >= Skv) continue;
    const long base = (((long)b * Skv + j) * Kh + kh) * D + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + n * 8) =
          pack_bf16(acc_k[n][2 * rr] * scale, acc_k[n][2 * rr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + n * 8) =
          pack_bf16(acc_v[n][2 * rr], acc_v[n][2 * rr + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kTcWarps)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int Kh,
                         int causal, int window, float scale, float scale_log2) {
  using C = Tc<D>;
  constexpr int kThreadsQ = 32 * kTcWarps;
  constexpr int kS = tc_stride<D>();
  constexpr int kDK = D / 16;                    // k steps of S and dP
  constexpr int kDN = D / 8;                     // n-tiles of dQ
  constexpr int kNK = C::kChunkK / 8;            // n-tiles of a chunk's scores
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_tc);   // 64 x kS
  __nv_bfloat16* do_s = q_s + kBlock * kS;                           // 64 x kS
  __nv_bfloat16* k_s = do_s + kBlock * kS;                           // kStages x 64 x kS
  __nv_bfloat16* v_s = k_s + kStages * kBlock * kS;                  // kStages x 64 x kS

  // query blocks in the slowest grid dimension, last first: under a causal
  // mask the last sees every KV block, so the heaviest CTAs start first
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBlock;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / Kh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int offset = Skv - Sq;
  const Mask mask{Sq, Skv, offset, causal, window};

  // the forward's live KV range for these rows
  const int first_q = i0 + offset;
  const int last_q = min(i0 + kBlock, Sq) - 1 + offset;
  const int kv_end = causal ? min(Skv, last_q + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, first_q - window + 1) / kBlock * kBlock : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBlock - 1) / kBlock : 0;

  const long q_stride = (long)H * D, kv_stride = (long)Kh * D;
  const long q_at = ((long)b * Sq + i0) * H + h;
  const __nv_bfloat16* kb = k + ((long)b * Skv * Kh + kh) * D;
  const __nv_bfloat16* vb = v + ((long)b * Skv * Kh + kh) * D;
  auto stage_kv = [&](int it, int buf) {         // KV tile it into stage buf
    const int j0 = kv_begin + it * kBlock;
    stage_tile<D, kThreadsQ>(k_s + buf * kBlock * kS, kb + j0 * kv_stride, kv_stride,
                             Skv - j0);
    stage_tile<D, kThreadsQ>(v_s + buf * kBlock * kS, vb + j0 * kv_stride, kv_stride,
                             Skv - j0);
  };
  if (n_tiles > 0) {                             // else dQ = 0
    stage_tile<D, kThreadsQ>(q_s, q + q_at * D, q_stride, Sq - i0);
    stage_tile<D, kThreadsQ>(do_s, dout + q_at * D, q_stride, Sq - i0);
    stage_kv(0, 0);
  }
  cp_async_commit();

  // the lane's rows g and g + 8: their LSE (log2 units) and Delta
  const int qa = i0 + warp * 16, qb = qa + 15;   // the warp's query rows
  const int pa = qa + offset, pb = qb + offset;
  float lse2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = qa + g + 8 * rr;
    const long at = ((long)b * H + h) * Sq + i;
    lse2[rr] = i < Sq ? lse[at] * kLog2e : 0.f;
    dl[rr] = i < Sq ? delta[at] : 0.f;
  }

  uint32_t qf[C::kKeepA ? kDK : 1][4], dof[C::kKeepA ? kDK : 1][4];
  float acc[kDN][4];                             // rows g, g + 8; columns 8 n + 2 t
#pragma unroll
  for (int n = 0; n < kDN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = kv_begin + it * kBlock, buf = it % kStages;
    if (it + 1 < n_tiles) stage_kv(it + 1, buf ^ 1);   // overlaps this tile's math
    cp_async_commit();
    cp_async_wait_all_but_one();                 // tile it (and q, dO) have landed
    __syncthreads();
    if constexpr (C::kKeepA) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < kDK; ++kk) {
          ldmatrix_x4(qf[kk], q_s + a_at<kS>(warp * 16, kk, lane));
          ldmatrix_x4(dof[kk], do_s + a_at<kS>(warp * 16, kk, lane));
        }
      }
    }
    const __nv_bfloat16* kt = k_s + buf * kBlock * kS;
    const __nv_bfloat16* vt = v_s + buf * kBlock * kS;

#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += C::kChunkK) {
      const int ja = j0 + c0, jb = ja + C::kChunkK - 1;   // the chunk's keys
      const bool live = qa < Sq && ja < Skv && !(causal && ja > pb) &&
                        !(window > 0 && jb <= pa - window);
      if (!live) continue;

      // S = q K^T and dP = dO V^T: 16 queries x kChunkK keys
      float s[kNK][4], dp[kNK][4];
#pragma unroll
      for (int n = 0; n < kNK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
        uint32_t qa4[4], da4[4];
        if constexpr (C::kKeepA) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa4[e] = qf[kk][e], da4[e] = dof[kk][e];
        } else {
          ldmatrix_x4(qa4, q_s + a_at<kS>(warp * 16, kk, lane));
          ldmatrix_x4(da4, do_s + a_at<kS>(warp * 16, kk, lane));
        }
#pragma unroll
        for (int np = 0; np < kNK / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, kt + b_rows_n<kS>(c0 + np * 16, kk, lane));
          mma_bf16(s[2 * np], qa4, r[0], r[1]);
          mma_bf16(s[2 * np + 1], qa4, r[2], r[3]);
          ldmatrix_x4(r, vt + b_rows_n<kS>(c0 + np * 16, kk, lane));
          mma_bf16(dp[2 * np], da4, r[0], r[1]);
          mma_bf16(dp[2 * np + 1], da4, r[2], r[3]);
        }
      }

      // P and dS in place: rows g (e 0, 1) and g + 8 (e 2, 3)
      const bool edge = jb >= Skv || (causal && jb > pa) || (window > 0 && ja <= pb - window);
#pragma unroll
      for (int n = 0; n < kNK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
          if (edge && !mask.ok(qa + g + 8 * (e >> 1), ja + n * 8 + 2 * t + (e & 1))) p = 0.f;
          dp[n][e] = p * (dp[n][e] - dl[e >> 1]);
        }
      }

      // dQ += dS K: K rows are the k index (ldmatrix.trans)
#pragma unroll
      for (int kk = 0; kk < C::kChunkK / 16; ++kk) {
        const uint32_t sa4[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                 pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                 pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                 pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < kDN / 2; ++dn) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, kt + b_rows_k<kS>(c0 + kk * 16, dn * 16, lane));
          mma_bf16(acc[2 * dn], sa4, r[0], r[1]);
          mma_bf16(acc[2 * dn + 1], sa4, r[2], r[3]);
        }
      }
    }
    __syncthreads();                             // stage buf is free for tile it + 2
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = qa + g + 8 * rr;
    if (i >= Sq) continue;
    const long base = (((long)b * Sq + i) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kDN; ++n)
      *reinterpret_cast<uint32_t*>(dq + base + n * 8) =
          pack_bf16(acc[n][2 * rr] * scale, acc[n][2 * rr + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Delta, and the launches
// ---------------------------------------------------------------------------

// Delta = rowsum(dO * O) in f32 for a (batch, query row, head) row: a group
// of `lanes` lanes (a power of two) a row, 16-byte loads
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long rows, int Sq, int H, int D, int lanes) {
  constexpr int kVec = 16 / sizeof(T);
  const long row = ((long)blockIdx.x * kThreads + threadIdx.x) / lanes;
  const int sub = threadIdx.x % lanes;
  float acc = 0.f;
  if (row < rows) {
    for (int c = sub * kVec; c < D; c += lanes * kVec) {
      const uint4 a = *reinterpret_cast<const uint4*>(out + row * D + c);
      const uint4 d = *reinterpret_cast<const uint4*>(dout + row * D + c);
      const T* x = reinterpret_cast<const T*>(&a);
      const T* y = reinterpret_cast<const T*>(&d);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc = fmaf(to_f32(x[i]), to_f32(y[i]), acc);
    }
  }
  for (int m = lanes / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && sub == 0) {   // row = (b * Sq + i) * H + h -> (b, h, i)
    const int h = static_cast<int>(row % H);
    const long bi = row / H;
    const long b = bi / Sq, i = bi % Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int B, int Sq, int H,
                         int D, cudaStream_t stream) {
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  const long rows = (long)B * Sq * H;
  const long blocks = (rows * lanes + kThreads - 1) / kThreads;
  flash_bwd_delta_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows, Sq, H, D, lanes);
  return cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
               int Skv, int H, int Kh, int causal, int window, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);

  cudaError_t err = launch_delta<float>(out, dout, delta, B, Sq, H, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv((Skv + kBlock - 1) / kBlock, Kh, B);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv,
      H, Kh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((Sq + kBlock - 1) / kBlock, H, B);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), Sq, Skv, H, Kh, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                int B, int Sq, int Skv, int H, int Kh, int causal, int window,
                cudaStream_t stream) {
  using C = Tc<D>;
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemKv);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemQ);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);

  cudaError_t err = launch_delta<bf>(out, dout, delta, B, Sq, H, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv(Kh, B, (Skv + kBlock - 1) / kBlock);
  flash_bwd_dkdv_bf16_kernel<D><<<grid_kv, C::kKvThreads, C::kSmemKv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Skv, H,
      Kh, causal, window, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q(H, B, (Sq + kBlock - 1) / kBlock);
  flash_bwd_dq_bf16_kernel<D><<<grid_q, 32 * kTcWarps, C::kSmemQ, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dq), Sq, Skv, H, Kh, causal, window,
      scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
             int Skv, int H, int Kh, int causal, int window, bool bf16, cudaStream_t s) {
  return bf16 ? launch_bf16<D>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                               causal, window, s)
              : launch_f32<D>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                              causal, window, s);
}

int dispatch_d(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
               int Skv, int H, int Kh, int D, int causal, int window, bool bf16,
               cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_d<32>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                          causal, window, bf16, s);
    case 64:
      return launch_d<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                          causal, window, bf16, s);
    case 128:
      return launch_d<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                           causal, window, bf16, s);
    case 192:
      return launch_d<192>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                           causal, window, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no sliding window. lse (B, H, Sq) f32 is the forward's;
// delta (B, H, Sq) f32 is scratch the caller allocates. dq, dk, dv are
// written whole (zero where no pair is visible). Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                   int Skv, int H, int Kh, int D, int causal, int window,
                                   int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kh <= 0 || H % Kh != 0 || H > 65535 || Kh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_d(q, k, v, out, dout, static_cast<const float*>(lse),
                    static_cast<float*>(delta), dq, dk, dv, B, Sq, Skv, H, Kh, D, causal,
                    window, is_bf16 != 0, static_cast<cudaStream_t>(stream));
}
