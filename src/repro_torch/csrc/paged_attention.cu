// Paged decode attention for Hopper (sm_90a), one query token per sequence.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_kernel, body _kernel). Same function: GQA with
// G = H / Kh query heads per KV head, f32 online softmax scaled by D^-0.5,
// the planner's block descriptors walked in order, token mask
// `tok < nvalid*T && cnt*T + tok < length`, blocks with nvalid = 0 leave
// the carry untouched, output acc / max(l, 1e-30).
//
// Layouts (all contiguous):
//   q           (B, H, D)            f32 or bf16
//   kv          (P, T, 2, Kh, D)     same dtype; K and V interleaved on axis 2
//   block_start (B, NB) int32        first page of each block (a run of pages)
//   block_valid (B, NB) int32        pages in the block, 0 = empty
//   lengths     (B,)    int32        tokens in the sequence
//   out         (B, H, D)            q's dtype
//
// Design. One CTA of 128 threads per (sequence, KV head) reads each K/V
// row of its head once and serves all G query rows from it. The pages of
// one block are contiguous, so a block's tokens are one contiguous stretch
// of the pool; the CTA stages them 32 tokens at a time in shared memory
// (as f32), computes the G x 32 scores, updates the running max and sum
// (m, l: registers of the warp that owns the row) and the accumulator
// (acc: registers, G*D values spread over the CTA). Only the valid pages of
// a block are read, and the walk stops at the sequence's length, so the
// R-1 slack pages the pool keeps are never touched.
//
// Bound on this card: bytes. Decode reads every cached K/V row once per
// step and does 4*D flops per row and query head, far below the ~295
// flops/byte at which an H100 turns compute-bound. The simple loads here
// (2 bytes a thread, no copy/compute overlap) do not reach the memory
// rate; the TPU kernel's double-buffered block copies map to cp.async or
// TMA pipelining, which is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // tokens staged per step: one per lane
constexpr int kMaxGroup = 8;      // query heads per KV head
constexpr int kRowsPerWarp = kMaxGroup / kWarps;
constexpr float kNegInf = -1e30f; // finite: exp(kNegInf - kNegInf) is 1, not NaN

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                       const int* __restrict__ block_start,
                       const int* __restrict__ block_valid,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int Kh, int page_tokens, int NB, float scale) {
  constexpr int kAcc = kMaxGroup * D / kThreads;   // acc values per thread
  __shared__ float q_s[kMaxGroup][D];
  __shared__ float k_s[kChunk][D + 1];             // +1: conflict-free row reads
  __shared__ float v_s[kChunk][D];
  __shared__ float p_s[kMaxGroup][kChunk];
  __shared__ float corr_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int b = blockIdx.x / Kh, kh = blockIdx.x % Kh;
  const int G = H / Kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row_stride = 2L * Kh * D;             // one token: K row then V row
  const T* kv_head = kv + (long)kh * D;

  for (int idx = tid; idx < G * D; idx += kThreads)
    q_s[idx / D][idx % D] = to_float(q[((long)b * H + kh * G) * D + idx]);

  float acc[kAcc];
  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) { m_r[r] = kNegInf; l_r[r] = 0.f; }

  const int len = lengths[b];
  int done = 0;                                    // tokens of earlier blocks
  for (int i = 0; i < NB; ++i) {
    const int nvalid = block_valid[b * NB + i];
    if (nvalid <= 0) continue;
    const int remaining = len - done;
    if (remaining <= 0) break;                     // all later tokens masked
    const int ntok = min(nvalid * page_tokens, remaining);
    const long first = (long)block_start[b * NB + i] * page_tokens;
    done += nvalid * page_tokens;

    for (int c0 = 0; c0 < ntok; c0 += kChunk) {
      const int n = min(kChunk, ntok - c0);
      __syncthreads();                             // last chunk's readers are done
      for (int idx = tid; idx < n * D; idx += kThreads) {
        const int t = idx / D, d = idx % D;
        const T* row = kv_head + (first + c0 + t) * row_stride + d;
        k_s[t][d] = to_float(row[0]);
        v_s[t][d] = to_float(row[(long)Kh * D]);
      }
      __syncthreads();
      for (int pidx = tid; pidx < G * kChunk; pidx += kThreads) {
        const int g = pidx / kChunk, t = pidx % kChunk;
        float s = kNegInf;
        if (t < n) {
          float a = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) a += q_s[g][d] * k_s[t][d];
          s = a * scale;
        }
        p_s[g][t] = s;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int g = warp + r * kWarps;
        if (g < G) {
          const float s = p_s[g][lane];
          const float m_new = fmaxf(m_r[r], warp_max(s));
          const float p = expf(s - m_new);
          const float corr = expf(m_r[r] - m_new);
          l_r[r] = l_r[r] * corr + warp_sum(p);
          m_r[r] = m_new;
          p_s[g][lane] = p;
          if (lane == 0) corr_s[g] = corr;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int idx = tid + j * kThreads, g = idx / D, d = idx % D;
        if (g < G) {
          float a = acc[j] * corr_s[g];
          for (int t = 0; t < n; ++t) a += p_s[g][t] * v_s[t][d];
          acc[j] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int g = warp + r * kWarps;
    if (g < G && lane == 0) l_s[g] = l_r[r];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int idx = tid + j * kThreads, g = idx / D, d = idx % D;
    if (g < G)
      out[((long)b * H + kh * G + g) * D + d] = from_float<T>(acc[j] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kv, const void* block_start,
           const void* block_valid, const void* lengths, void* out, int B, int H,
           int Kh, int page_tokens, int NB, cudaStream_t stream) {
  paged_attention_kernel<T, D><<<B * Kh, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const int*>(block_start), static_cast<const int*>(block_valid),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Kh, page_tokens,
      NB, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kv, const void* bs, const void* bv,
               const void* len, void* out, int B, int H, int Kh, int D, int T_,
               int NB, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, kv, bs, bv, len, out, B, H, Kh, T_, NB, s);
    case 64: return launch<T, 64>(q, kv, bs, bv, len, out, B, H, Kh, T_, NB, s);
    case 128: return launch<T, 128>(q, kv, bs, bv, len, out, B, H, Kh, T_, NB, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* kv,
                                   const void* block_start, const void* block_valid,
                                   const void* lengths, void* out, int B, int H,
                                   int Kh, int D, int page_tokens, int NB,
                                   int is_bf16, void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || H / Kh > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch_d<__nv_bfloat16>(q, kv, block_start, block_valid, lengths, out, B,
                                  H, Kh, D, page_tokens, NB, s)
      : dispatch_d<float>(q, kv, block_start, block_valid, lengths, out, B, H, Kh,
                          D, page_tokens, NB, s);
}
