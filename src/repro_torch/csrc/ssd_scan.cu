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
// Training runs a second forward, ssd_scan_fwd_states (at the end of this
// file; serving's code above it is what it was). It also writes the state
// entering each chunk, states (B, L / chunk, H, N, P), which the backward
// (ssd_scan_bwd.cu) reads. And it is exact f32 where serving's is 3xTF32
// and sums cs in f32: with cs summed in f64 (a dt rounded to f32 first) and
// every product an f32 FMA on the CUDA cores, as the backward computes.
// Serving's forward under training puts full-width mamba2-780m's f32
// gradients 1.3e-3 off the plain path's, this one 3.3e-5 (on an H100,
// tools/ssd_grads_split.py; chip_smoke.py holds them to 1e-4): 48 layers
// amplify serving's ~1e-5 in y. The plain version is
// ref.py::ssd_chunked(..., cs64=True). Three
// launches: C . B^T (ssd_f32.cuh), the sweep of h over the chunks a CTA per
// (b, h), writing each chunk's entering state, then y a CTA per (64-token row
// block, chunk, h, b) from those states.
//
// Bound on this card: operations. At the serving shape (B 4, L 512, H 48,
// P 64, N 128, K 256) the function needs ~4.9 GFLOP, counting the causal
// half of each K x K product and the head-shared C . B^T once per
// (b, chunk), against ~59 MB of inputs and outputs. f32-accurate products
// run on the tensor cores as three TF32 products (below), at 495 / 3 =
// 165 TFLOP/s: ~0.030 ms, against ~0.018 ms of bytes at 3.35 TB/s.
//
// Design: two launches on the caller's stream.
//
// 1. ssd_cb_kernel writes the causal half of C . B^T once per (b, chunk)
//    into a scratch buffer that the wrapper allocates (K x K f32 per
//    (b, chunk), 2 MB at the serving shape, L2-resident). C . B^T does not
//    depend on the head, so the 48 heads of a chunk read it instead of
//    recomputing it. The tile of 16 rows x 8 columns is stored as one
//    float4 per lane in the mma accumulator layout, which is exactly the
//    A-fragment layout the scan reads back (see the column order below):
//    one coalesced 16-byte load per lane per tile.
// 2. ssd_scan_kernel: one CTA of 8 warps per (head, batch) loops over the
//    chunks with h_prev (N x P) in shared memory. Per chunk: a block-wide
//    prefix sum of dt * A, x staged in shared memory with 16-byte cp.async,
//    then
//    - y, one 16-row m-tile at a time: C . h_prev (C fragments straight
//      from device memory, two k steps ahead of the mma), scaled by
//      exp(cs_i), plus the masked scores (C . B^T tiles from the scratch,
//      times exp(cs_i - cs_j) * dt_j, selected to 0 above the diagonal,
//      never multiplied by a mask: inf * 0 = NaN) times x. Warp w owns
//      m-tiles w and 15 - w, so the causal work is even across warps;
//    - the state update (B * w)^T . x into registers, warp w owning state
//      rows 16w..16w+15, initialised with exp(cs_last) * h_prev; it is
//      committed to shared memory only after a barrier, once every warp has
//      read h_prev for its inbound term.
//    The A side of every product (device-memory loads, the TF32 split, the
//    exp of the mask) is the costly part, so a CTA takes all 64 columns of
//    P and spends it on 8 n-tiles. Measured on an NVIDIA H100 80GB HBM3
//    (700 W) at the serving shape: 64 columns a CTA (192 CTAs, one an SM at
//    ~230 registers) beat 32 (384 CTAs, two an SM at 128 registers) and 16
//    by 11-18 %, though 192 CTAs fill 132 SMs in 1.45 waves.
//
// Every product is mma.sync.m16n8k8 TF32 -> f32 on the tensor cores with
// each f32 operand split as hi = tf32(a), lo = tf32(a - hi), accumulating
// lo.hi + hi.lo + hi.hi in f32 (3xTF32): ~2^-22 relative per product, like
// f32, where one TF32 product (~1e-3) would break the 1e-4 tolerance.
//
// Column order inside an 8-wide k step: logical k column t (t = lane % 4)
// is physical column 2t and logical t + 4 is 2t + 1, so a lane's two A
// elements of a row are adjacent (one float2 load), and its two B elements
// are rows 2t and 2t + 1 of the shared tile. Shared rows are 68 floats
// apart (== 4 mod 16), which makes those B-fragment reads free of bank
// conflicts.
//
// Ragged edges are zero-padded to the mma tile and masked: rows and columns
// past K, N or P are loaded as 0 and never written, so any K <= 256 with
// L % K == 0, N <= 128 and P <= 64 is taken.

#include <cuda_runtime.h>

#include <cstdint>

#include "ssd_f32.cuh"

namespace {

constexpr int kThreads = 256;                    // scan CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCbThreads = 128;                  // C . B^T CTA: 64 columns
constexpr int kMaxChunk = 256, kMaxN = 128, kMaxP = 64;
constexpr int kPSlice = 64;                      // y and h columns a scan CTA owns
constexpr int kNT = kPSlice / 8;                 // its n-tiles of 8 columns
constexpr int kStride = kPSlice + 4;             // x_s, h_s row stride in floats

static_assert(kMaxChunk <= kThreads, "the prefix sum gives one token per thread");
static_assert(kMaxChunk <= 2 * kWarps * 16, "two m-tiles a warp cover the chunk");
static_assert(kMaxN <= kWarps * 16, "one state m-tile a warp covers N");

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

__host__ __device__ constexpr int smem_floats(int K, int N) {
  return round16(K) * kStride      // x_s: the chunk's x columns of this slice
         + round16(N) * kStride    // h_s: the carried state
         + 3 * round16(K)          // cs_s, dt_s, w_s
         + kWarps;                 // warp totals of the prefix sum
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// f32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds: two integer ops at the full ALU rate,
// where the conversion instruction issues at a fraction of it
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4)
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// b0 (k t, column g), b1 (k t + 4, column g)
__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[nt] += a . b_nt over the slice's n-tiles of 8 columns, B fragments read
// from a shared tile at `bp` (rows bp and bp + stride, n-tile nt at column
// 8 nt); the three terms go out term by term, so consecutive mma are
// independent
__device__ __forceinline__ void mma3_row(float (&d)[kNT][4], const FragA& a, const float* bp,
                                         int stride) {
  FragB b[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) b[nt] = split_b(bp[nt * 8], bp[stride + nt * 8]);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) mma_tf32(d[nt], a.lo, b[nt].hi);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) mma_tf32(d[nt], a.hi, b[nt].lo);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) mma_tf32(d[nt], a.hi, b[nt].hi);
}

// row[n], row[n + 1], zero at or past `limit` (0 for a padding row); `vec`
// when the row start is 8-byte aligned, so the pair is one load
__device__ __forceinline__ float2 ld_pair(const float* row, int n, int limit, bool vec) {
  if (vec && n + 1 < limit) return __ldg(reinterpret_cast<const float2*>(row + n));
  return make_float2(n < limit ? __ldg(row + n) : 0.f,
                     n + 1 < limit ? __ldg(row + n + 1) : 0.f);
}

// B[j][na], B[j][nb], B[j + 1][na], B[j + 1][nb] of a chunk's rows `Bc`,
// zero past K rows and N columns: the state update's raw A fragment
__device__ __forceinline__ float4 ld_bt(const float* Bc, int j, int K, int N, int na, int nb) {
  const float* r0 = Bc + (long)j * N;
  const bool j0 = j < K, j1 = j + 1 < K, a = na < N, b = nb < N;
  return make_float4(j0 && a ? __ldg(r0 + na) : 0.f, j0 && b ? __ldg(r0 + nb) : 0.f,
                     j1 && a ? __ldg(r0 + N + na) : 0.f, j1 && b ? __ldg(r0 + N + nb) : 0.f);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// C . B^T for one (b, chunk) and one 16-row m-tile, 64 columns a CTA: warp w
// owns the two 8-column tiles at columns 64 * blockIdx.y + 16 w, skipped when
// they lie above the diagonal. Each tile is stored as 32 lanes x float4
// (c0, c1, c2, c3) of the accumulator: (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1). Small warps, many of them, and operands two k steps ahead:
// the kernel is latency-bound, not mma-bound.
__global__ void __launch_bounds__(kCbThreads)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float4* __restrict__ cb, int L, int N, int K, int n_chunks) {
  const int mi = blockIdx.x, bc = blockIdx.z;    // bc = b * n_chunks + chunk
  const int nM = gridDim.x, nK8 = 2 * nM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kt0 = blockIdx.y * 8 + warp * 2;     // the warp's first column tile
  if (kt0 > 2 * mi + 1) return;                  // both tiles above the diagonal
  const long row0 = (long)(bc / n_chunks) * L + (long)(bc % n_chunks) * K;
  const bool vec = N % 2 == 0;
  const int i = mi * 16 + g, j = kt0 * 8 + g;
  const float* c_a = Cm + (row0 + i) * N;        // A rows i, i + 8
  const float* b_a = Bm + (row0 + j) * N;        // B rows j (tile kt0), j + 8 (kt0 + 1)
  const int lc_a = i < K ? N : 0, lc_b = i + 8 < K ? N : 0;
  const int lb_a = j < K ? N : 0, lb_b = j + 8 < K ? N : 0;

  float acc[2][4] = {};
  float2 op[2][4];                               // operands of the next two k steps
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int n = st * 8 + 2 * t;
    op[st][0] = ld_pair(c_a, n, lc_a, vec);
    op[st][1] = ld_pair(c_a + 8L * N, n, lc_b, vec);
    op[st][2] = ld_pair(b_a, n, lb_a, vec);
    op[st][3] = ld_pair(b_a + 8L * N, n, lb_b, vec);
  }
  for (int n0 = 0; n0 < N; n0 += 8) {
    const float2 u = op[0][0], v = op[0][1], w0 = op[0][2], w1 = op[0][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) op[0][e] = op[1][e];
    const int n = n0 + 16 + 2 * t;
    op[1][0] = ld_pair(c_a, n, lc_a, vec);
    op[1][1] = ld_pair(c_a + 8L * N, n, lc_b, vec);
    op[1][2] = ld_pair(b_a, n, lb_a, vec);
    op[1][3] = ld_pair(b_a + 8L * N, n, lb_b, vec);
    const FragA a = split_a(u.x, v.x, u.y, v.y);
    const FragB b0 = split_b(w0.x, w0.y), b1 = split_b(w1.x, w1.y);
    mma_tf32(acc[0], a.lo, b0.hi);
    mma_tf32(acc[1], a.lo, b1.hi);
    mma_tf32(acc[0], a.hi, b0.lo);
    mma_tf32(acc[1], a.hi, b1.lo);
    mma_tf32(acc[0], a.hi, b0.hi);
    mma_tf32(acc[1], a.hi, b1.hi);
  }
  float4* dst = cb + ((long)bc * nM + mi) * nK8 * 32 + lane;
  dst[kt0 * 32] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
  dst[(kt0 + 1) * 32] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A, const float4* __restrict__ cb,
                float* __restrict__ y, float* __restrict__ h_final, int L, int H, int P,
                int N, int K) {
  extern __shared__ float4 smem4[];
  const int K16 = round16(K), N16 = round16(N), nM = K16 / 16, nK8 = 2 * nM;
  float* x_s = reinterpret_cast<float*>(smem4);  // K16 x kStride
  float* h_s = x_s + K16 * kStride;              // N16 x kStride
  float* cs_s = h_s + N16 * kStride;             // K16, zero past K
  float* dt_s = cs_s + K16;                      // K16, zero past K
  float* w_s = dt_s + K16;                       // K16: dt_j * exp(cs_last - cs_j)
  float* warp_s = w_s + K16;                     // kWarps

  const int p_base = blockIdx.x * kPSlice, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pw = min(kPSlice, P - p_base);       // columns of this slice that exist
  const float a = A[h];
  const long tok = (long)H * P;                  // between tokens in x and y
  const float* xb = x + (long)b * L * tok + (long)h * P + p_base;
  float* yb = y + (long)b * L * tok + (long)h * P + p_base;
  const float* Bb = Bm + (long)b * L * N;
  const float* Cb = Cm + (long)b * L * N;
  const float* dtb = dt + (long)b * L * H + h;
  const bool vec_n = N % 2 == 0, vec_p = P % 2 == 0, x16 = P % 4 == 0;
  const int n_chunks = L / K;

  for (int e = tid; e < N16 * kStride; e += kThreads) h_s[e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * K;
    // --- x of the chunk, zero past K rows and past P columns
    const float* xc = xb + (long)c0 * tok;
    if (x16) {
      for (int e = tid; e < K16 * (kPSlice / 4); e += kThreads) {
        const int j = e / (kPSlice / 4), q = e % (kPSlice / 4) * 4;
        const bool ok = j < K && q < pw;
        cp_async16(x_s + j * kStride + q, ok ? xc + j * tok + q : xb, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
      for (int e = tid; e < K16 * kPSlice; e += kThreads) {
        const int j = e / kPSlice, q = e % kPSlice;
        x_s[j * kStride + q] = j < K && q < pw ? __ldg(xc + j * tok + q) : 0.f;
      }
    }

    // --- cs = cumsum(dt * A) over the chunk: warp scans, then warp totals
    float d = 0.f, v = 0.f;
    if (tid < K) {
      d = dtb[(long)(c0 + tid) * H];
      v = d * a;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_s[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float u = lane < kWarps ? warp_s[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const float s = __shfl_up_sync(0xffffffffu, u, o);
        if (lane >= o) u += s;
      }
      if (lane < kWarps) warp_s[lane] = u;
    }
    __syncthreads();
    if (warp > 0) v += warp_s[warp - 1];
    if (tid < K16) {
      dt_s[tid] = tid < K ? d : 0.f;
      cs_s[tid] = tid < K ? v : 0.f;
    }
    __syncthreads();
    const float cs_last = cs_s[K - 1];
    if (tid < K16) w_s[tid] = tid < K ? d * expf(cs_last - v) : 0.f;
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();                             // x_s, cs_s, dt_s, w_s ready

    // --- y, one m-tile at a time; warp w owns m-tiles w and 15 - w
    const float4* cbc = cb + ((long)b * n_chunks + c) * nM * nK8 * 32 + lane;
    for (int r = 0; r < 2; ++r) {
      const int mi = r == 0 ? warp : 2 * kWarps - 1 - warp;
      if (mi >= nM) continue;
      const int ia = mi * 16 + g, ib = ia + 8;
      float acc[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

      // inbound state: C_i . h_prev
      const float* c_a = Cb + (long)(c0 + ia) * N;
      const float* c_b = c_a + 8L * N;
      const int lim_a = ia < K ? N : 0, lim_b = ib < K ? N : 0;
      // device-memory fragments run two k steps ahead of the mma
      float2 u0 = ld_pair(c_a, 2 * t, lim_a, vec_n), w0 = ld_pair(c_b, 2 * t, lim_b, vec_n);
      float2 u1 = ld_pair(c_a, 8 + 2 * t, lim_a, vec_n);
      float2 w1 = ld_pair(c_b, 8 + 2 * t, lim_b, vec_n);
      for (int n0 = 0; n0 < N; n0 += 8) {
        const int n = n0 + 2 * t;
        const float2 u = u0, w = w0;
        u0 = u1;
        w0 = w1;
        u1 = ld_pair(c_a, n + 16, lim_a, vec_n);
        w1 = ld_pair(c_b, n + 16, lim_b, vec_n);
        const FragA fa = split_a(u.x, w.x, u.y, w.y);
        mma3_row(acc, fa, h_s + n * kStride + g, kStride);
      }
      const float cs_a = cs_s[ia], cs_b = cs_s[ib];
      const float dec_a = ia < K ? expf(cs_a) : 0.f, dec_b = ib < K ? expf(cs_b) : 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[nt][0] *= dec_a;
        acc[nt][1] *= dec_a;
        acc[nt][2] *= dec_b;
        acc[nt][3] *= dec_b;
      }

      // intra-chunk: the masked scores times x, column tiles at or below the diagonal
      const float4* src = cbc + (long)mi * nK8 * 32;
      const int last = 2 * mi + 1;               // >= 1: two tiles in flight
      float4 s0 = __ldg(src), s1 = __ldg(src + 32);
      for (int kt = 0; kt <= last; ++kt) {
        const float4 cur = s0;
        s0 = s1;
        if (kt + 2 <= last) s1 = __ldg(src + (kt + 2) * 32);
        const int j = kt * 8 + 2 * t;
        const float2 csj = *reinterpret_cast<const float2*>(cs_s + j);
        const float2 dtj = *reinterpret_cast<const float2*>(dt_s + j);
        // select, never multiply by a mask: exp above the diagonal is inf
        const FragA fa = split_a(
            j <= ia ? cur.x * expf(cs_a - csj.x) * dtj.x : 0.f,
            j <= ib ? cur.z * expf(cs_b - csj.x) * dtj.x : 0.f,
            j + 1 <= ia ? cur.y * expf(cs_a - csj.y) * dtj.y : 0.f,
            j + 1 <= ib ? cur.w * expf(cs_b - csj.y) * dtj.y : 0.f);
        mma3_row(acc, fa, x_s + j * kStride + g, kStride);
      }

#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = nt * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? ib : ia;
          if (i >= K) continue;
          float* dst = yb + (long)(c0 + i) * tok + col;
          const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
          if (vec_p && col + 1 < pw) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (col < pw) dst[0] = v0;
            if (col + 1 < pw) dst[1] = v1;
          }
        }
      }
    }

    // --- state update: warp w owns state rows 16w..16w+15
    const int na = warp * 16 + g, nb = na + 8;
    const bool owns = warp * 16 < N;
    float hacc[kNT][4];
    if (owns) {
      const float dec = expf(cs_last);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = nt * 8 + 2 * t;
        hacc[nt][0] = h_s[na * kStride + col] * dec;
        hacc[nt][1] = h_s[na * kStride + col + 1] * dec;
        hacc[nt][2] = h_s[nb * kStride + col] * dec;
        hacc[nt][3] = h_s[nb * kStride + col + 1] * dec;
      }
      const float* Bc = Bb + (long)c0 * N;
      float4 r0 = ld_bt(Bc, 2 * t, K, N, na, nb), r1 = ld_bt(Bc, 8 + 2 * t, K, N, na, nb);
      for (int kt = 0; kt < nK8; ++kt) {
        const int j = kt * 8 + 2 * t;
        const float4 r = r0;
        r0 = r1;
        r1 = ld_bt(Bc, j + 16, K, N, na, nb);
        // A[n][j] = B[j][n] * w_j; a0 (na, j), a1 (nb, j), a2 (na, j + 1), a3 (nb, j + 1)
        const float2 wj = *reinterpret_cast<const float2*>(w_s + j);
        const FragA fa = split_a(r.x * wj.x, r.y * wj.x, r.z * wj.y, r.w * wj.y);
        mma3_row(hacc, fa, x_s + j * kStride + g, kStride);
      }
    }
    __syncthreads();                             // every warp has read h_prev
    if (owns) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = nt * 8 + 2 * t;
        h_s[na * kStride + col] = hacc[nt][0];
        h_s[na * kStride + col + 1] = hacc[nt][1];
        h_s[nb * kStride + col] = hacc[nt][2];
        h_s[nb * kStride + col + 1] = hacc[nt][3];
      }
    }
    __syncthreads();                             // h_s committed; x_s, cs_s free
  }

  if (h_final != nullptr) {
    float* dst = h_final + ((long)b * H + h) * N * P + p_base;
    for (int e = tid; e < N * kPSlice; e += kThreads) {
      const int n = e / kPSlice, q = e % kPSlice;
      if (q < pw) dst[(long)n * P + q] = h_s[n * kStride + q];
    }
  }
}

}  // namespace

// The training forward's kernels (see the top of the file).
namespace ssd_f32 {

// h over the chunks, a CTA per (h, b): thread (tn, tp) owns
// h[tn + 32 r][tp + 8 q], r < 4, q < 8. Per chunk: h to states, then
// h <- exp(cs_last) h + sum_j w_j B_j (x) x_j over tiles of 32 tokens,
// w_j = dt_j exp(cs_last - cs_j); h_final (if not null) after the last.
static __global__ void __launch_bounds__(kThreads)
fwd_state_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 float* __restrict__ states, float* __restrict__ h_final, int L, int H, int P,
                 int N, int K) {
  __shared__ __align__(16) float b_tile[32 * kS128], x_tile[32 * kS64];
  __shared__ double cs_s[kMaxChunk], wsum[kWarps];
  __shared__ float dt_s[kMaxChunk], w_s[kMaxChunk];
  const int h = blockIdx.x, b = blockIdx.y, nC = L / K;
  const int tid = threadIdx.x, tn = tid >> 3, tp = tid & 7;
  const float a = A[h];
  const long tokH = (long)H * P;
  float hs[4][8] = {};
  for (int c = 0; c < nC; ++c) {
    const int c0 = c * K;
    float* st = states + (((long)b * nC + c) * H + h) * N * P;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tn + 32 * r, p = tp + 8 * q;
        if (n < N && p < P) st[(long)n * P + p] = hs[r][q];
      }
    chunk_cs(dt + ((long)b * L + c0) * H + h, H, K, a, cs_s, dt_s, wsum);
    const double cs_last = cs_s[K - 1];
    if (tid < K) w_s[tid] = dt_s[tid] * expf(static_cast<float>(cs_last - cs_s[tid]));
    const float e_last = expf(static_cast<float>(cs_last));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) hs[r][q] *= e_last;
    const float* Bc = Bm + ((long)b * L + c0) * N;
    const float* xc = x + ((long)b * L + c0) * tokH + (long)h * P;
    __syncthreads();                             // w_s ready
    for (int j0 = 0; j0 < K; j0 += 32) {
      for (int e = tid; e < 32 * kMaxN; e += kThreads) {
        const int r = e / kMaxN, n = e % kMaxN, j = j0 + r;
        b_tile[r * kS128 + n] = j < K && n < N ? w_s[j] * __ldg(Bc + (long)j * N + n) : 0.f;
      }
      for (int e = tid; e < 32 * kMaxP; e += kThreads) {
        const int r = e / kMaxP, p = e % kMaxP, j = j0 + r;
        x_tile[r * kS64 + p] = j < K && p < P ? __ldg(xc + (long)j * tokH + p) : 0.f;
      }
      __syncthreads();
      const int rows = min(32, K - j0);
      for (int r = 0; r < rows; ++r) {
        float bv[4], xv[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = b_tile[r * kS128 + tn + 32 * k];
#pragma unroll
        for (int k = 0; k < 8; ++k) xv[k] = x_tile[r * kS64 + tp + 8 * k];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 8; ++m) hs[k][m] += bv[k] * xv[m];
      }
      __syncthreads();
    }
  }
  if (h_final != nullptr) {
    float* dst = h_final + ((long)b * H + h) * N * P;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tn + 32 * r, p = tp + 8 * q;
        if (n < N && p < P) dst[(long)n * P + p] = hs[r][q];
      }
  }
}

// shared memory of fwd_y_kernel, in floats: cs, wsum (doubles), dt, then the
// larger of its two views
constexpr int kYHead = 2 * kMaxChunk + 2 * kWarps + kMaxChunk;
constexpr int kYSmem = kYHead + 2 * kMaxN * kS64;
static_assert(kYHead % 4 == 0, "16-byte aligned tiles");
static_assert(2 * kT * kS64 <= 2 * kMaxN * kS64, "the loop view fits the init view");

// y of row block ib (heaviest first), chunk, head, batch: exp(cs_i) C_i . h-
// plus sum_{j<=i} W_ij x_j, W_ij = G_ij exp(cs_i - cs_j) dt_j (0 above the
// diagonal, by select). Thread (iq, pq) owns y[4 iq + r][4 pq + q].
static __global__ void __launch_bounds__(kThreads)
fwd_y_kernel(const float* __restrict__ x, const float* __restrict__ Cm,
             const float* __restrict__ dt, const float* __restrict__ A,
             const float* __restrict__ G, const float* __restrict__ states,
             float* __restrict__ y, int L, int H, int P, int N, int K) {
  extern __shared__ float4 smem4[];
  double* cs_s = reinterpret_cast<double*>(smem4);
  double* wsum = cs_s + kMaxChunk;
  float* dt_s = reinterpret_cast<float*>(wsum + kWarps);
  float* U = reinterpret_cast<float*>(smem4) + kYHead;
  float* ct = U;                                 // init: C[i][n] at [n][i]
  float* hn = ct + kMaxN * kS64;                 //       h-[n][p] at [n][p]
  float* xn = U;                                 // loop: x[j][p] at [j][p]
  float* wt = xn + kT * kS64;                    //       W[i][j] at [j][i]

  const int nT = (K + kT - 1) / kT, ib = nT - 1 - blockIdx.x, i0 = ib * kT;
  const int c = blockIdx.y / H, h = blockIdx.y % H, b = blockIdx.z, nC = L / K, c0 = c * K;
  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const long tokH = (long)H * P;
  const float* xc = x + ((long)b * L + c0) * tokH + (long)h * P;
  const float* Cc = Cm + ((long)b * L + c0) * N;
  const float* hp = states + (((long)b * nC + c) * H + h) * N * P;
  const float* Gc = G + ((long)b * nC + c) * K * K;

  for (int e = tid; e < kT * kMaxN; e += kThreads) {
    const int r = e / kMaxN, n = e % kMaxN, i = i0 + r;
    ct[n * kS64 + r] = i < K && n < N ? __ldg(Cc + (long)i * N + n) : 0.f;
  }
  for (int e = tid; e < kMaxN * kMaxP; e += kThreads) {
    const int n = e / kMaxP, p = e % kMaxP;
    hn[n * kS64 + p] = n < N && p < P ? __ldg(hp + (long)n * P + p) : 0.f;
  }
  chunk_cs(dt + ((long)b * L + c0) * H + h, H, K, A[h], cs_s, dt_s, wsum);

  float acc[4][4] = {};
  for (int n = 0; n < N; ++n) {
    const float4 cv = ld4(ct + n * kS64 + 4 * hi), hv = ld4(hn + n * kS64 + 4 * lo);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] += el(cv, r) * el(hv, q);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * hi + r;
    const float ecs = i < K ? expf(static_cast<float>(cs_s[i])) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] *= ecs;
  }
  __syncthreads();                               // the init view is read

  for (int jb = 0; jb <= ib; ++jb) {
    const int j0 = jb * kT;
    for (int e = tid; e < kT * kMaxP; e += kThreads) {
      const int r = e / kMaxP, p = e % kMaxP, j = j0 + r;
      xn[r * kS64 + p] = j < K && p < P ? __ldg(xc + (long)j * tokH + p) : 0.f;
    }
    float w[4][4];                               // rows 4 hi.., columns 4 lo..
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * hi + r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = j0 + 4 * lo + s;
        w[r][s] = 0.f;
        if (i < K && j <= i) {
          const float lij = expf(fminf(static_cast<float>(cs_s[i] - cs_s[j]), 0.f));
          w[r][s] = __ldg(Gc + (long)i * K + j) * lij * dt_s[j];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      st4(wt + (4 * lo + s) * kS64 + 4 * hi, w[0][s], w[1][s], w[2][s], w[3][s]);
    __syncthreads();
    const int cols = min(kT, K - j0);
    for (int jj = 0; jj < cols; ++jj) {
      const float4 wv = ld4(wt + jj * kS64 + 4 * hi), xv = ld4(xn + jj * kS64 + 4 * lo);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] += el(wv, r) * el(xv, q);
    }
    __syncthreads();
  }

  float* yb = y + ((long)b * L + c0) * tokH + (long)h * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * hi + r;
    if (i >= K) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * lo + q < P) yb[(long)i * tokH + 4 * lo + q] = acc[r][q];
  }
}

}  // namespace ssd_f32

// h_final may be null (then only y is written). cb_scratch holds
// B * (L / chunk) * round16(chunk)^2 floats of C . B^T tiles. Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int ssd_scan_fwd(const void* x, const void* Bm, const void* Cm,
                            const void* dt, const void* A, void* y, void* h_final,
                            void* cb_scratch, int B, int L, int H, int P, int N,
                            int chunk, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || L <= 0 || chunk <= 0 ||
      chunk > kMaxChunk || L % chunk != 0 || (long)B * (L / chunk) > 65535 || N <= 0 || N > kMaxN ||
      P <= 0 || P > kMaxP || cb_scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(kMaxChunk, kMaxN) * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nM = round16(chunk) / 16, n_chunks = L / chunk;
  ssd_cb_kernel<<<dim3(nM, (nM + 3) / 4, B * n_chunks), kCbThreads, 0, s>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float4*>(cb_scratch), L, N, chunk, n_chunks);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  const int smem = smem_floats(chunk, N) * static_cast<int>(sizeof(float));
  ssd_scan_kernel<<<dim3((P + kPSlice - 1) / kPSlice, H, B), kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float4*>(cb_scratch),
      static_cast<float*>(y), static_cast<float*>(h_final), L, H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The training forward (see the top of the file): y, h_final (may be null)
// and the state entering each chunk, states (B, L / chunk, H, N, P); all f32
// CUDA-core arithmetic, cs in f64. cb_scratch holds C . B^T, K x K a (b,
// chunk): the same buffer ssd_scan_fwd takes is large enough. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int ssd_scan_fwd_states(const void* x, const void* Bm, const void* Cm,
                                   const void* dt, const void* A, void* y, void* h_final,
                                   void* cb_scratch, void* states, int B, int L, int H,
                                   int P, int N, int chunk, void* stream) {
  namespace f = ssd_f32;
  if (B <= 0 || B > 65535 || H <= 0 || L <= 0 || chunk <= 0 || chunk > f::kMaxChunk ||
      L % chunk != 0 || (long)(L / chunk) * H > 65535 || H > 65535 || N <= 0 ||
      N > f::kMaxN || P <= 0 || P > f::kMaxP || cb_scratch == nullptr || states == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      f::fwd_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      f::kYSmem * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nC = L / chunk, nT = (chunk + f::kT - 1) / f::kT;
  const float *fx = static_cast<const float*>(x), *fB = static_cast<const float*>(Bm),
              *fC = static_cast<const float*>(Cm), *fdt = static_cast<const float*>(dt),
              *fA = static_cast<const float*>(A);
  float* G = static_cast<float*>(cb_scratch);
  float* fst = static_cast<float*>(states);
  cudaError_t e;
  f::g_kernel<<<dim3(nT * nT, nC, B), f::kThreads, 0, s>>>(fB, fC, G, L, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  f::fwd_state_kernel<<<dim3(H, B), f::kThreads, 0, s>>>(
      fx, fB, fdt, fA, fst, static_cast<float*>(h_final), L, H, P, N, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  f::fwd_y_kernel<<<dim3(nT, nC * H, B), f::kThreads, f::kYSmem * sizeof(float), s>>>(
      fx, fC, fdt, fA, G, fst, static_cast<float*>(y), L, H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}
