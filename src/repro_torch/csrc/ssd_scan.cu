// SSD (Mamba-2) chunk scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py (ssd_scan,
// body _kernel). Same function: x (B, L, H, P), Bm and Cm (B, L, N) shared
// by every head (n_groups = 1), dt (B, L, H), A (H,), all f32. For each
// (b, h) the chunks of K tokens are swept in order with a state h (N x P,
// f32) that starts at zero; per chunk, with cs = cumsum(dt * A):
//
//   y = ((C . B^T) * L * dt_j) . x + exp(cs) * (C . h_prev),
//       L_ij = exp(cs_i - cs_j) for i >= j, 0 above the diagonal
//   h = exp(cs_last) * h_prev + (B * dt * exp(cs_last - cs))^T . x
//
// One addition to the TPU kernel: given a non-null h_final, the state after
// the last chunk is written to h_final (B, H, N, P). The TPU kernel keeps
// it in VMEM scratch and drops it; serving needs it to start decode.
//
// Design. The TPU kernel carries h across a sequential grid axis; here one
// CTA of 256 threads per (h, b) loops over the chunks itself, with h in
// shared memory. Per chunk: a block-wide prefix sum of dt * A (warp
// shuffles, then the warp totals), then the chunk's rows in tiles of 32.
// Each row tile stages its C rows once, adds the inbound-state term from
// h, and walks the column tiles at or below it, staging B and x, forming
// the masked 32 x 32 score tile and accumulating scores . x into registers
// (each thread holds 8 columns of one row). The state update rides the
// last row tile's walk, which visits every column tile: each thread keeps
// 32 elements of the new h in registers and commits them to shared memory
// once the chunk's y is written. Above the diagonal the exponent is
// positive and exp overflows, so those entries are selected as 0, never
// multiplied by a mask (inf * 0 = NaN); exp(cs) underflowing to 0 over a
// long chunk is correct. Rows past K in a ragged tile are staged as 0 and
// not written, so any K <= 256 with L % K == 0 is taken, and N <= 128,
// P <= 64.
//
// Bound on this card: operations. At the serving shape (B 4, L 512, H 48,
// P 64, N 128, K 256) the function needs ~4.9 GFLOP, counting the causal
// half of each K x K product and the head-shared C . B^T once per
// (b, chunk): ~0.073 ms at 67 TFLOP/s f32, against ~59 MB of inputs and
// outputs, ~0.018 ms at 3.35 TB/s. What this design does about it:
// nothing yet. The products run on the f32 CUDA cores from shared memory,
// and each head recomputes C . B^T. Tensor-core tiles (TF32 or bf16 mma)
// and a head-shared C . B^T are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                        // rows of a row or column tile
constexpr int kMaxChunk = 256, kMaxN = 128, kMaxP = 64;
constexpr int kColLanes = 8;                     // threads sharing one y row
constexpr int kYCols = kMaxP / kColLanes;        // y columns a thread holds
constexpr int kScoreCols = kTile / kColLanes;    // score columns a thread forms
constexpr int kStateRows = kThreads / kMaxP;     // h rows covered per pass
constexpr int kHRegs = kMaxN / kStateRows;       // h elements a thread holds

static_assert(kMaxChunk <= kThreads, "the prefix sum gives one token per thread");

__host__ __device__ constexpr int smem_floats(int K, int N, int P) {
  return N * P                    // h_s: the carried state
         + 2 * kTile * (N + 1)    // c_s, b_s: C row tile, B column tile
         + kTile * P              // x_s: x column tile
         + kTile * (kTile + 1)    // s_s: masked scores
         + 3 * K                  // dt_s, cs_s, w_s
         + kWarps;                // warp totals of the prefix sum
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ h_final, int L, int H, int P, int N, int K) {
  extern __shared__ float smem[];
  float* h_s = smem;                             // N x P
  float* c_s = h_s + N * P;                      // kTile x (N + 1)
  float* b_s = c_s + kTile * (N + 1);            // kTile x (N + 1)
  float* x_s = b_s + kTile * (N + 1);            // kTile x P
  float* s_s = x_s + kTile * P;                  // kTile x (kTile + 1)
  float* dt_s = s_s + kTile * (kTile + 1);       // K
  float* cs_s = dt_s + K;                        // K
  float* w_s = cs_s + K;                         // K: dt_j * exp(cs_last - cs_j)
  float* warp_s = w_s + K;                       // kWarps

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a = A[h];
  const long tok_stride = (long)H * P;           // between tokens in x and y
  const float* xb = x + (long)b * L * tok_stride + (long)h * P;
  float* yb = y + (long)b * L * tok_stride + (long)h * P;
  const float* Bb = Bm + (long)b * L * N;
  const float* Cb = Cm + (long)b * L * N;
  const float* dtb = dt + (long)b * L * H + h;

  // y and score roles: row r of a tile, column lane q
  const int r = tid / kColLanes, q = tid % kColLanes;
  // state role: column sp, rows sn0 + kStateRows * m
  const int sp = tid % kMaxP, sn0 = tid / kMaxP;
  const bool owns_state = sp < P;

  for (int e = tid; e < N * P; e += kThreads) h_s[e] = 0.f;
  float hreg[kHRegs];
  const int n_tiles = (K + kTile - 1) / kTile;

  for (int c0 = 0; c0 < L; c0 += K) {
    // --- cs = cumsum(dt * A) over the chunk: warp scans, then warp totals
    float d = 0.f, v = 0.f;
    if (tid < K) {
      d = dtb[(long)(c0 + tid) * H];
      v = d * a;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) warp_s[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float t = lane < kWarps ? warp_s[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += u;
      }
      if (lane < kWarps) warp_s[lane] = t;
    }
    __syncthreads();
    if (warp > 0) v += warp_s[warp - 1];
    if (tid < K) {
      dt_s[tid] = d;
      cs_s[tid] = v;
    }
    __syncthreads();
    const float cs_last = cs_s[K - 1];
    if (tid < K) w_s[tid] = d * expf(cs_last - v);
    // the carried state, decayed over the whole chunk; the chunk's own
    // contributions are added during the last row tile's column walk
    const float decay_all = expf(cs_last);
#pragma unroll
    for (int m = 0; m < kHRegs; ++m) {
      const int n = sn0 + kStateRows * m;
      hreg[m] = owns_state && n < N ? h_s[n * P + sp] * decay_all : 0.f;
    }

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile, gi = i0 + r;
      for (int idx = tid; idx < kTile * N; idx += kThreads) {
        const int i = idx / N, n = idx % N;
        c_s[i * (N + 1) + n] = i0 + i < K ? Cb[(long)(c0 + i0 + i) * N + n] : 0.f;
      }
      __syncthreads();   // c_s staged; w_s written (first tile)

      // inbound state: exp(cs_i) * (C_i . h_prev)
      float acc[kYCols];
#pragma unroll
      for (int e = 0; e < kYCols; ++e) acc[e] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float cv = c_s[r * (N + 1) + n];
#pragma unroll
        for (int e = 0; e < kYCols; ++e) {
          const int p = q + kColLanes * e;
          if (p < P) acc[e] += cv * h_s[n * P + p];
        }
      }
      const float cs_i = gi < K ? cs_s[gi] : 0.f;
      const float decay_in = gi < K ? expf(cs_i) : 0.f;
#pragma unroll
      for (int e = 0; e < kYCols; ++e) acc[e] *= decay_in;

      // intra-chunk: column tiles at or below the row tile
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile, jn = min(kTile, K - j0);
        for (int idx = tid; idx < kTile * N; idx += kThreads) {
          const int j = idx / N, n = idx % N;
          b_s[j * (N + 1) + n] = j < jn ? Bb[(long)(c0 + j0 + j) * N + n] : 0.f;
        }
        for (int idx = tid; idx < kTile * P; idx += kThreads) {
          const int j = idx / P, p = idx % P;
          x_s[idx] = j < jn ? xb[(long)(c0 + j0 + j) * tok_stride + p] : 0.f;
        }
        __syncthreads();

        float s[kScoreCols];
#pragma unroll
        for (int k = 0; k < kScoreCols; ++k) s[k] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float cv = c_s[r * (N + 1) + n];
#pragma unroll
          for (int k = 0; k < kScoreCols; ++k)
            s[k] += cv * b_s[(q + kColLanes * k) * (N + 1) + n];
        }
#pragma unroll
        for (int k = 0; k < kScoreCols; ++k) {
          const int j = q + kColLanes * k, gj = j0 + j;
          // select, never multiply by a mask: exp above the diagonal is inf
          s_s[r * (kTile + 1) + j] =
              (gi < K && gj <= gi) ? s[k] * expf(cs_i - cs_s[gj]) * dt_s[gj] : 0.f;
        }
        __syncthreads();

        for (int j = 0; j < jn; ++j) {
          const float sv = s_s[r * (kTile + 1) + j];
#pragma unroll
          for (int e = 0; e < kYCols; ++e) {
            const int p = q + kColLanes * e;
            if (p < P) acc[e] += sv * x_s[j * P + p];
          }
        }
        if (it == n_tiles - 1 && owns_state) {
          // state update: h += (B_j * w_j)^T . x_j over this column tile
          for (int j = 0; j < jn; ++j) {
            const float coef = w_s[j0 + j] * x_s[j * P + sp];
#pragma unroll
            for (int m = 0; m < kHRegs; ++m) {
              const int n = sn0 + kStateRows * m;
              if (n < N) hreg[m] += b_s[j * (N + 1) + n] * coef;
            }
          }
        }
        __syncthreads();   // b_s, x_s, s_s free for the next column tile
      }

      if (gi < K) {
        float* dst = yb + (long)(c0 + gi) * tok_stride;
#pragma unroll
        for (int e = 0; e < kYCols; ++e) {
          const int p = q + kColLanes * e;
          if (p < P) dst[p] = acc[e];
        }
      }
    }

    // every row tile has read h_prev (the last column walk ended in a
    // barrier): commit the new state
    if (owns_state) {
#pragma unroll
      for (int m = 0; m < kHRegs; ++m) {
        const int n = sn0 + kStateRows * m;
        if (n < N) h_s[n * P + sp] = hreg[m];
      }
    }
    __syncthreads();
  }

  if (h_final != nullptr && owns_state) {
    float* dst = h_final + ((long)b * H + h) * N * P;
#pragma unroll
    for (int m = 0; m < kHRegs; ++m) {
      const int n = sn0 + kStateRows * m;
      if (n < N) dst[n * P + sp] = hreg[m];
    }
  }
}

}  // namespace

// h_final may be null (then only y is written). Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int ssd_scan_fwd(const void* x, const void* Bm, const void* Cm,
                            const void* dt, const void* A, void* y, void* h_final,
                            int B, int L, int H, int P, int N, int chunk,
                            void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || L <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      L % chunk != 0 || N <= 0 || N > kMaxN || P <= 0 || P > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(kMaxChunk, kMaxN, kMaxP) * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int smem = smem_floats(chunk, N, P) * static_cast<int>(sizeof(float));
  ssd_scan_kernel<<<dim3(H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(h_final), L, H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}
