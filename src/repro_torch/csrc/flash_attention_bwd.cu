// Flash attention backward for Hopper (sm_90a).
//
// The TPU side has no backward kernel: the reference trains through
// src/repro/models/attention.py (attention_train -> flash_attention_jnp,
// :201 and :65), which JAX differentiates by autodiff. This is the gradient
// of the forward in flash_attention.cu, from what that forward saves: q, k,
// v, o and each query row's log-sum-exp (natural log) of its scaled scores.
// Same layouts and masks as the forward: q, o, dO, dq (B, Sq, H, D); k, v,
// dk, dv (B, Skv, Kh, D); head h reads KV head h / G (G = H / Kh); query row
// i sits at position i + Skv - Sq; causal keeps kv <= q, a window keeps
// kv > q - window, kv >= Skv is masked. With s = scale * q . k:
//
//   P  = exp(s - LSE)                (recomputed, never stored)
//   dV = P^T dO           dP = dO V^T          Delta = rowsum(dO * O)
//   dS = P * (dP - Delta) dQ = scale * dS K     dK = scale * dS^T Q
//
// dK and dV sum over the G query heads of their KV head. Three launches:
// 1. delta: Delta (B, H, Sq) f32, one warp a query row;
// 2. dkdv: one CTA per (KV block of 64 rows, KV head, batch). It walks the
//    G heads and, for each, the query blocks that can see its KV block (the
//    forward's causal and window skips, seen from the key side), recomputes
//    S and dP for the 64 x 64 tile, and accumulates dK and dV in f32
//    registers; each is written once;
// 3. dq: one CTA per (query block of 64 rows, head, batch). It walks the KV
//    blocks its rows can see and accumulates dQ in f32 registers.
// No atomics: every output element is summed by one thread in a fixed
// order, so two runs on the same inputs give the same bits (a checkpoint
// resume reproduces uninterrupted training exactly). The price is S and dP
// computed twice, seven 64 x 64 x D products a tile pair instead of five.
//
// A simple design, right first: f32 and bf16 inputs alike are staged in
// shared memory as f32 (rows padded to D + 1 floats, so the 16 rows a
// half-warp reads at one d fall in 16 banks), and every product runs on the
// CUDA cores in f32 from 4 x 4 register tiles (256 threads as 16 x 16; a
// thread owns rows ty + 16 r and columns tx + 16 c). Outputs are rounded to
// the input dtype once. Head dims 32, 64, 128 and 192 (MLA: qk_nope + qk_rope,
// V padded up to it); at 192 a CTA takes 231,424 bytes of shared memory, just
// under the 232,448 a block may use, and holds 96 f32 accumulators a thread.
//
// Bound on this card: at the training shape (B 8, S 512, H 12, Kh 4, D 64,
// bf16, causal) bytes: q, k, v, o, dO, LSE, Delta read and dq, dk, dv
// written once are 34 MB, 10.1 us at 3.35 TB/s, against the five products'
// 10 * D flops a visible (query, key) pair, 8.1 GFLOP, 8.2 us on the bf16
// tensor cores. This kernel runs seven products at the f32 CUDA-core rate
// (67 TFLOP/s at best, less with two shared loads a pair of FMAs), so it is
// compute-bound far off that bound. mma.sync (or wgmma) with the forward's
// fragment layouts is the way to it: S^T = K Q^T puts P^T in the
// accumulator layout that is the A operand of dV = P^T dO.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kBlock = 64;         // query and KV rows a tile
constexpr int kPS = kBlock + 1;    // padded row of a 64 x 64 score tile

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 1; }

template <int D>
constexpr int smem_bytes() {       // four 64 x D tiles, two score tiles, LSE and Delta
  return (4 * kBlock * row_stride<D>() + 2 * kBlock * kPS + 2 * kBlock) *
         static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows x D of T from device memory (row stride `stride` elements) into an
// f32 shared tile with padded rows; rows >= `valid` are zero. 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long stride, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int e = threadIdx.x; e < kBlock * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks * kVec;
    float* d = dst + r * row_stride<D>() + c;
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) d[i] = to_f32(x[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) d[i] = 0.f;
    }
  }
}

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
#pragma unroll 4
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int Kh,
                      int causal, int window, float scale) {
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
  stage<T, D>(k_s, k + ((long)b * Skv * Kh + (long)k0 * Kh + kh) * D, kv_stride, Skv - k0);
  stage<T, D>(v_s, v + ((long)b * Skv * Kh + (long)k0 * Kh + kh) * D, kv_stride, Skv - k0);

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
      stage<T, D>(q_s, q + (((long)b * Sq + i0) * H + h) * D, q_stride, Sq - i0);
      stage<T, D>(do_s, dout + (((long)b * Sq + i0) * H + h) * D, q_stride, Sq - i0);
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
      store(dk + base + tx + 16 * c, acc_k[r][c] * scale);
      store(dv + base + tx + 16 * c, acc_v[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv,
                    int H, int Kh, int causal, int window, float scale) {
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
  stage<T, D>(q_s, q + (((long)b * Sq + i0) * H + h) * D, q_stride, Sq - i0);
  stage<T, D>(do_s, dout + (((long)b * Sq + i0) * H + h) * D, q_stride, Sq - i0);
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
    stage<T, D>(k_s, k + ((long)b * Skv * Kh + (long)j0 * Kh + kh) * D, kv_stride, Skv - j0);
    stage<T, D>(v_s, v + ((long)b * Skv * Kh + (long)j0 * Kh + kh) * D, kv_stride, Skv - j0);
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
#pragma unroll 4
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
    for (int c = 0; c < kC; ++c) store(dq + base + tx + 16 * c, acc[r][c] * scale);
  }
}

// Delta = rowsum(dO * O) in f32, one warp a (batch, query row, head)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long rows, int Sq, int H, int D) {
  const long row = (long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* d = dout + row * D;
  float acc = 0.f;
  for (int e = lane; e < D; e += 32) acc = fmaf(to_f32(o[e]), to_f32(d[e]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {   // row = (b * Sq + i) * H + h -> (b, h, i)
    const int h = static_cast<int>(row % H);
    const long bi = row / H;
    const long b = bi / Sq, i = bi % Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
           int Skv, int H, int Kh, int causal, int window, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const long rows = (long)B * Sq * H;
  const long warps_a_block = kThreads / 32;
  flash_bwd_delta_kernel<T><<<(rows + warps_a_block - 1) / warps_a_block, kThreads, 0,
                              stream>>>(static_cast<const T*>(out), dot, delta, rows, Sq, H,
                                        D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv((Skv + kBlock - 1) / kBlock, Kh, B);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, Kh,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((Sq + kBlock - 1) / kBlock, H, B);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Skv, H, Kh, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
               int Skv, int H, int Kh, int D, int causal, int window, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                           causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                           causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                            causal, window, s);
    case 192:
      return launch<T, 192>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kh,
                            causal, window, s);
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
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Skv,
                                             H, Kh, D, causal, window, s)
                 : dispatch_d<float>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, Kh,
                                     D, causal, window, s);
}
