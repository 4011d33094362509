// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _kernel). Same function: q (B, Sq, H, D) against
// k, v (B, Skv, Kh, D); head h reads KV head h / G (G = H / Kh); query row
// i sits at position i + Skv - Sq; causal keeps kv <= q, a window keeps
// kv > q - window, kv >= Skv is masked; f32 online softmax scaled by
// D^-0.5; output acc / max(l, 1e-30) in q's dtype. KV tiles wholly in the
// causal future or wholly left of the window are skipped.
//
// Design. One CTA of 128 threads per (q tile of 32 rows, head, batch).
// The CTA stages its q tile once, then walks the live KV tiles of 32 rows,
// staging K and V in shared memory as f32. Four neighbouring lanes share
// one query row: each computes 8 of the row's 32 scores, the four reduce
// the row max and sum with shuffles, and each keeps D/4 accumulator
// columns in registers. The kernel masks ragged edges itself (q rows
// >= Sq, kv rows >= Skv), so unlike the TPU kernel it needs no
// Sq % q_block or Skv % kv_block.
//
// Bound on this card: at the serving shapes (prefill of 64 tokens, D = 64)
// bytes, since a causal 64 x 64 tile does ~2 flops per byte read; at long
// sequences the score and PV products make it compute-bound. The products
// here run on the f32 CUDA cores; mma.sync / wgmma tiles fed by TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;
constexpr int kLanesPerRow = kThreads / kBlockQ;       // 4
constexpr int kColsPerLane = kBlockK / kLanesPerRow;   // 8
constexpr float kNegInf = -1e30f;  // finite: a fully masked first tile washes out

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_bytes() {
  return (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
                       int H, int Kh, int causal, int window, float scale) {
  constexpr int kAcc = D / kLanesPerRow;
  extern __shared__ float smem[];
  float* q_s = smem;                          // kBlockQ x (D + 1)
  float* k_s = q_s + kBlockQ * (D + 1);       // kBlockK x (D + 1)
  float* v_s = k_s + kBlockK * (D + 1);       // kBlockK x D
  float* p_s = v_s + kBlockK * D;             // kBlockQ x (kBlockK + 1)

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x, row = tid / kLanesPerRow, quad = tid % kLanesPerRow;
  const int offset = Skv - Sq;                // query row i sits at i + offset

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D, qi = q0 + i;
    q_s[i * (D + 1) + d] =
        qi < Sq ? to_float(q[(((long)b * Sq + qi) * H + h) * D + d]) : 0.f;
  }

  // live KV range: tiles past the last query (causal) or wholly left of the
  // first query's window are skipped
  const int first_q = q0 + offset;
  const int last_q = min(q0 + kBlockQ, Sq) - 1 + offset;
  const int kv_end = causal ? min(Skv, last_q + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, first_q - window + 1) / kBlockK * kBlockK : 0;

  const int qpos = q0 + row + offset;
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();                          // last tile's readers are done
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, kj = k0 + j;
      const long src = (((long)b * Skv + kj) * Kh + kh) * D + d;
      k_s[j * (D + 1) + d] = kj < Skv ? to_float(k[src]) : 0.f;
      v_s[j * D + d] = kj < Skv ? to_float(v[src]) : 0.f;
    }
    __syncthreads();

    float s[kColsPerLane];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = quad + kLanesPerRow * c, kpos = k0 + col;
      float a = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) a += q_s[row * (D + 1) + d] * k_s[col * (D + 1) + d];
      bool ok = kpos < Skv;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[c] = ok ? a * scale : kNegInf;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const float p = expf(s[c] - m_new);
      p_s[row * (kBlockK + 1) + quad + kLanesPerRow * c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();                             // the row's four lanes share p_s
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] *= corr;
    for (int j = 0; j < kBlockK; ++j) {
      const float p = p_s[row * (kBlockK + 1) + j];
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] += p * v_s[j * D + quad + kLanesPerRow * e];
    }
  }

  const int qi = q0 + row;
  if (qi < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* dst = out + (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) dst[quad + kLanesPerRow * e] = from_float<T>(acc[e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Skv, int H, int Kh, int causal, int window, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, Kh, causal, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B, int Sq,
               int Skv, int H, int Kh, int D, int causal, int window, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, Kh, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, Kh, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, Kh, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no sliding window. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Skv, int H, int Kh,
                                   int D, int causal, int window, int is_bf16,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kh <= 0 || H % Kh != 0 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, Kh, D,
                                             causal, window, s)
                 : dispatch_d<float>(q, k, v, out, B, Sq, Skv, H, Kh, D, causal,
                                     window, s);
}
