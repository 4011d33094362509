// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _kernel). Same function: q (B, Sq, H, D) against
// k, v (B, Skv, Kh, D); head h reads KV head h / G (G = H / Kh); query row
// i sits at position i + Skv - Sq; causal keeps kv <= q, a window keeps
// kv > q - window, kv >= Skv is masked; f32 online softmax scaled by
// D^-0.5; output acc / max(l, 1e-30) in q's dtype. KV tiles wholly in the
// causal future or wholly left of the window are skipped. Both kernels
// mask ragged edges themselves (q rows >= Sq, kv rows >= Skv), so unlike
// the TPU kernel they need no Sq % q_block or Skv % kv_block. Head dims 32,
// 64, 128 and 192 (MLA's prefill: qk_nope + qk_rope, V padded up to it). At
// 192 the bf16 kernel's tiles take (64 + 4 x 64) x 200 x 2 = 128,000 bytes of
// shared memory and the f32 kernel's 78,208, under the 227 KB a block may use.
//
// bf16 (the serving path): tensor cores. One CTA of 4 warps per (64-row
// q tile, head, batch); each warp owns 16 query rows.
// - q, K and V tiles are staged in shared memory as bf16 with 16-byte
//   cp.async copies; KV tiles of 64 rows are double-buffered, so the next
//   tile's copy runs while the current one computes. Rows are padded by
//   16 bytes (D + 8 elements), so the 8 rows an ldmatrix reads fall in 8
//   distinct bank groups: no conflicts.
// - S = q . K^T with mma.sync.m16n8k16 bf16 -> f32; the warp's q fragments
//   stay in registers (ldmatrix once) for the whole KV walk. At D = 192
//   that is 48 registers of q beside O's 96 and S's 32 in f32: ptxas
//   places the instance in 255 registers with no spill.
// - The online softmax runs on the accumulator fragments in registers:
//   each lane holds two rows, the row max and sum are reduced across the
//   four lanes of a quad with shuffles, and 2^x is one ex2.approx with
//   log2(e) folded into the scale. Masks are applied only on tiles that a
//   causal diagonal, a window edge or the ragged end of Skv crosses, and a
//   warp skips a tile that lies wholly outside its own rows' range.
// - P is rounded to bf16 in registers and fed straight in as the A operand
//   of the P . V mma (the accumulator layout of two n-tiles is the A layout
//   of one k step); V is read with ldmatrix.trans.
// - O stays in f32 registers; acc / max(l, 1e-30) goes out as bf16 through
//   shared memory with 16-byte stores.
// Tile height: 64 rows, four m16 warps sharing each K/V tile. At the
// serving shape (B 4, S 64, H 16) that is one q tile per (batch, head):
// 64 CTAs on 132 SMs, each with its whole causal problem in one KV tile,
// so the kernel is one load round trip plus four warps of mma. 128-row
// tiles (two m16 tiles a warp, each K/V fragment feeding both) halve the
// CTAs here and measured no faster at 4096 tokens (NVIDIA H100 80GB HBM3,
// 700 W); 16-row tiles would multiply the K/V reads by 4. q tiles are
// issued last-first, so at long causal prompts the heaviest tiles start
// first and the short ones fill the tail.
//
// f32 (off the serving path; its 2e-5 tolerance rules out TF32): a
// CUDA-core body. One CTA of 128 threads per (q tile of 32 rows, head,
// batch) stages q, K and V as f32 in shared memory; four neighbouring
// lanes share one query row and reduce its max and sum with shuffles.
//
// Bound on this card: at the serving shape (prefill of 64 tokens, D = 64)
// bytes, since a causal 64 x 64 tile does ~2 flops per byte read, and the
// kernel is latency-bound; at long prompts (4096 tokens) the score and PV
// products make it compute-bound at the bf16 tensor-core rate. There it
// runs at about a quarter of that rate: with 8-12 warps an SM, the per-tile
// chain of mma, exp2, shuffles and two barriers is latency-bound, and no
// one of the products or the exp2 dominates. wgmma fed by TMA with
// producer and consumer warps is the way past it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;
constexpr int kLanesPerRow = kThreads / kBlockQ;       // 4
constexpr int kColsPerLane = kBlockK / kLanesPerRow;   // 8
constexpr float kNegInf = -1e30f;  // finite: a fully masked first tile washes out

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
constexpr int smem_bytes() {
  return (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1)) *
         static_cast<int>(sizeof(float));
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Skv,
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
        qi < Sq ? q[(((long)b * Sq + qi) * H + h) * D + d] : 0.f;
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
      k_s[j * (D + 1) + d] = kj < Skv ? k[src] : 0.f;
      v_s[j * D + d] = kj < Skv ? v[src] : 0.f;
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
    float* dst = out + (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) dst[quad + kLanesPerRow * e] = acc[e] * inv;
    if constexpr (kLse) {
      if (quad == 0) lse[((long)b * H + h) * Sq + qi] = m + logf(fmaxf(l, 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;                  // four warps of 16 query rows
constexpr int kTcBlockQ = 64;                    // query rows a tile
constexpr int kTcBlockK = 64;                    // KV rows a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bf16 elements of a shared row: D plus 16 bytes of padding
template <int D>
__host__ __device__ constexpr int tc_stride() { return D + 8; }

template <int D>
constexpr int tc_smem_bytes() {                  // q tile, two K tiles, two V tiles
  return (kTcBlockQ + 4 * kTcBlockK) * tc_stride<D>() * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

// 2^x in one SFU instruction (exp2f adds range handling around the same
// instruction); P is rounded to bf16 right after, so its ~2 ulp are lost
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows x D bf16 from device memory (row stride `stride` elements) into a
// padded shared tile; rows >= `valid` are zero-filled
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long stride, int valid, int rows) {
  constexpr int kChunks = D / 8;                 // 16-byte chunks a row
  for (int e = threadIdx.x; e < rows * kChunks; e += kTcThreads) {
    const int r = e / kChunks, c = e % kChunks * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * tc_stride<D>() + c, ok ? src + r * stride + c : src, ok);
  }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                            int Skv, int H, int Kh, int causal, int window, float scale_log2) {
  constexpr int kS = tc_stride<D>();
  constexpr int kDK = D / 16;                    // k steps of q . K^T
  constexpr int kDN = D / 8;                     // n-tiles of O
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_tc);   // 64 x kS, then O
  __nv_bfloat16* k_s = q_s + kTcBlockQ * kS;                         // 2 x 64 x kS
  __nv_bfloat16* v_s = k_s + 2 * kTcBlockK * kS;                     // 2 x 64 x kS

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBlockQ;           // last tile first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / Kh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int offset = Skv - Sq;                   // query row i sits at i + offset

  const int first_q = q0 + offset;
  const int last_q = min(q0 + kTcBlockQ, Sq) - 1 + offset;
  const int kv_end = causal ? min(Skv, last_q + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, first_q - window + 1) / kTcBlockK * kTcBlockK : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kTcBlockK - 1) / kTcBlockK : 0;

  const long kv_stride = (long)Kh * D;
  const __nv_bfloat16* kb = k + ((long)b * Skv * Kh + kh) * D;
  const __nv_bfloat16* vb = v + ((long)b * Skv * Kh + kh) * D;
  stage_tile<D>(q_s, q + (((long)b * Sq + q0) * H + h) * D, (long)H * D, Sq - q0, kTcBlockQ);
  asm volatile("cp.async.commit_group;\n" ::);
  if (n_tiles > 0) {
    stage_tile<D>(k_s, kb + kv_begin * kv_stride, kv_stride, Skv - kv_begin, kTcBlockK);
    stage_tile<D>(v_s, vb + kv_begin * kv_stride, kv_stride, Skv - kv_begin, kTcBlockK);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 1;\n" ::);   // the q tile has landed
  __syncthreads();

  uint32_t qf[kDK][4];                           // this warp's 16 rows, kept for the walk
#pragma unroll
  for (int kk = 0; kk < kDK; ++kk)
    ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * kS + kk * 16 + (lane >> 4) * 8);

  const int w_first = q0 + warp * 16 + offset, w_last = w_first + 15;   // the warp's rows
  const int qpos[2] = {w_first + g, w_first + g + 8};                   // the lane's rows
  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this lane's share of the row

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * kTcBlockK, buf = it & 1;
    if (it + 1 < n_tiles) {                      // next tile's copy overlaps this one's math
      const int k1 = k0 + kTcBlockK;
      stage_tile<D>(k_s + (buf ^ 1) * kTcBlockK * kS, kb + k1 * kv_stride, kv_stride,
                    Skv - k1, kTcBlockK);
      stage_tile<D>(v_s + (buf ^ 1) * kTcBlockK * kS, vb + k1 * kv_stride, kv_stride,
                    Skv - k1, kTcBlockK);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);   // tile `it` has landed
    __syncthreads();
    const __nv_bfloat16* kt_s = k_s + buf * kTcBlockK * kS;
    const __nv_bfloat16* vt_s = v_s + buf * kTcBlockK * kS;

    // a tile wholly in this warp's causal future or left of its window adds
    // nothing (every row has an unmasked key in an earlier or later tile)
    const bool live = q0 + warp * 16 < Sq && !(causal && k0 > w_last) &&
                      !(window > 0 && k0 + kTcBlockK - 1 <= w_first - window);
    if (live) {
      // S = q . K^T: 16 rows x 64 columns a warp
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, kt_s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kS + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
        }
      }

      // mask only where a diagonal, a window edge or the end of Skv crosses the tile
      const bool edge = k0 + kTcBlockK > Skv || (causal && k0 + kTcBlockK - 1 > w_first) ||
                        (window > 0 && k0 <= w_last - window);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (edge) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1), qp = qpos[e >> 1];
            bool ok = kpos < Skv;
            if (causal) ok = ok && kpos <= qp;
            if (window > 0) ok = ok && kpos > qp - window;
            if (!ok) x = kNegInf;
          }
          s[n][e] = x;
        }
      }

      // online softmax on the fragments: rows g (e 0, 1) and g + 8 (e 2, 3);
      // the four lanes of a quad share a row
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[rr], mx);
        const float corr = fast_exp2(m[rr] - mn);
        m[rr] = mn;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[n][2 * rr] = fast_exp2(s[n][2 * rr] - mn);
          s[n][2 * rr + 1] = fast_exp2(s[n][2 * rr + 1] - mn);
          sum += s[n][2 * rr] + s[n][2 * rr + 1];
        }
        l[rr] = l[rr] * corr + sum;
#pragma unroll
        for (int n = 0; n < kDN; ++n) {
          o[n][2 * rr] *= corr;
          o[n][2 * rr + 1] *= corr;
        }
      }

      // O += P . V: two S n-tiles are one A fragment of a 16-deep k step
#pragma unroll
      for (int kk = 0; kk < kTcBlockK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vt_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kS +
                                   dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pa, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();                             // buffer `buf` is free for tile it + 2
  }

  // epilogue: each warp writes its own 16 rows of q_s as O, then 16-byte stores
  __nv_bfloat16* o_s = q_s + warp * 16 * kS;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    if constexpr (kLse) {   // m is in log2 units (scale_log2): back to a natural log
      const int qi = q0 + warp * 16 + g + 8 * rr;
      if (t == 0 && qi < Sq)
        lse[((long)b * H + h) * Sq + qi] = (m[rr] + log2f(fmaxf(sum, 1e-30f))) * kLn2;
    }
    __nv_bfloat16* dst = o_s + (g + 8 * rr) * kS + 2 * t;
#pragma unroll
    for (int n = 0; n < kDN; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(o[n][2 * rr] * inv, o[n][2 * rr + 1] * inv);
  }
  __syncwarp();
  for (int e = lane; e < 16 * (D / 8); e += 32) {
    const int r = e / (D / 8), c = e % (D / 8) * 8, qi = q0 + warp * 16 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(out + (((long)b * Sq + qi) * H + h) * D + c) =
          *reinterpret_cast<const uint4*>(o_s + r * kS + c);
  }
}

template <int D, bool kLse>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Sq, int Skv, int H, int Kh, int causal, int window, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kTcBlockQ - 1) / kTcBlockQ, H, B);
  flash_attention_bf16_kernel<D, kLse><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq, Skv,
      H, Kh, causal, window, kLog2e / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kLse>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int Sq, int Skv, int H, int Kh, int causal, int window, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_f32_kernel<D, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv, H, Kh, causal,
      window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// one (head dim, dtype) instance; the LSE-writing instances are separate
// kernels, so serving's (lse == nullptr) code is the same as without them
template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, float* lse, int B,
             int Sq, int Skv, int H, int Kh, int causal, int window, bool bf16,
             cudaStream_t s) {
  if (bf16)
    return lse ? launch_bf16<D, true>(q, k, v, out, lse, B, Sq, Skv, H, Kh, causal, window, s)
               : launch_bf16<D, false>(q, k, v, out, lse, B, Sq, Skv, H, Kh, causal, window, s);
  return lse ? launch_f32<D, true>(q, k, v, out, lse, B, Sq, Skv, H, Kh, causal, window, s)
             : launch_f32<D, false>(q, k, v, out, lse, B, Sq, Skv, H, Kh, causal, window, s);
}

int dispatch_d(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int Sq, int Skv, int H, int Kh, int D, int causal, int window, bool bf16,
               cudaStream_t s) {
  switch (D) {
    case 32: return launch_d<32>(q, k, v, out, lse, B, Sq, Skv, H, Kh, causal, window, bf16, s);
    case 64: return launch_d<64>(q, k, v, out, lse, B, Sq, Skv, H, Kh, causal, window, bf16, s);
    case 128:
      return launch_d<128>(q, k, v, out, lse, B, Sq, Skv, H, Kh, causal, window, bf16, s);
    case 192:   // MLA's prefill: qk_nope + qk_rope, V padded up to it
      return launch_d<192>(q, k, v, out, lse, B, Sq, Skv, H, Kh, causal, window, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no sliding window. With a non-null ``lse`` the kernel
// also writes each query row's log-sum-exp of its scaled scores, (B, H, Sq)
// f32 in natural log, log(max(l, 1e-30)) + m, for the backward
// (flash_attention_bwd.cu); serving passes null. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int Sq, int Skv, int H,
                                   int Kh, int D, int causal, int window, int is_bf16,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Kh <= 0 || H % Kh != 0 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_d(q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H, Kh, D, causal,
                    window, is_bf16 != 0, static_cast<cudaStream_t>(stream));
}
