// Decode attention over MLA's latent cache for Hopper (sm_90a): DeepSeek-V2's
// absorbed decode, one query token a sequence, every query head against one
// shared row of R latent values and dr rope-key values a cached token.
//
// Replaces no TPU kernel. The reference's mla_decode (src/repro/models/mla.py)
// attends over its latent cache with plain f32 products, and so did the port's:
// each layer cast the whole cache (every slot, live or not) to f32 and ran three
// f32 batched products with the mask and softmax between them, some 35.7 GB of
// copies and f32 reads a step at deepseek-v2-lite-16b.decode (B 64, 2,560
// slots, 27 layers). This kernel computes the same function
// (latent_attention_plain, kernels/latent_attention/ops.py) and reads each live
// cached byte once, in bf16.
//
// Function: for each sequence b and query head h,
//   s_t = (q_lat[b,h] . c_kv[b,t] + q_pe[b,h] . k_pe[b,t]) * scale   over the slots t with valid[b,t]
//   out[b,h] = sum_t softmax(s)_t c_kv[b,t]
// in f32, at the plain version's precision: q_lat (an f32 product) and P (f32
// probabilities) enter the tensor cores as sums of three bf16 terms (hi + mid +
// lo hold an f32 value exactly), the cached bf16 values are exact bf16
// operands, every product is exact and summed in f32. Only the order of the
// sums differs from the plain version's. Rounding q_lat or P once to bf16
// would be a lower precision (chip_smoke.py's latent phase shows the gap). A
// sequence with no valid slot gets zeros (the plain version's softmax would be
// uniform there; a step's plan always holds the step's own slot).
//
// Instances (R, dr): (512, 64) deepseek-v2-lite-16b, (32, 16) its reduced
// copy; a cache in bf16 (q_pe too) or f32 (an f32 copy of a model: every
// product on the CUDA cores). H is a runtime value: a CTA takes 16 query
// heads. Any other shape is refused (cudaErrorInvalidValue; the wrapper raises
// before).
//
// Layouts (all contiguous):
//   q_lat    (B, H, R)        f32: q_nope through W_kb
//   q_pe     (B, H, dr)       the cache's dtype
//   c_kv     (B, length, R)   bf16 or f32: one layer's slice of the latent cache
//   k_pe     (B, length, dr)  c_kv's dtype
//   valid    (B, length)      bool, one byte a slot: the step plan's mask
//   out      (B, H, R)        f32
//   partial  (B, H, S, R + 2) f32 scratch, only when S > 1: acc, m, l a split
//
// Bound on this card: bytes. A layer reads each live slot's R + dr bf16
// values once (1,152 bytes at V2-Lite's widths) against 2 * H * (2R + dr)
// flops a slot (about 30 a byte), far under the tensor cores' ridge. With the
// three-term splits the tensor cores still do about 100 kflop a slot, which
// mma.sync runs in under half the time the bytes take; on the CUDA cores in
// f32 (67 TFLOP/s) the pass would be bound by its flops instead.
//
// Design.
// - Grid (B * ceil(H / 16), S): a CTA takes one sequence, 16 query heads and
//   split s of the slots, [s*per, (s+1)*per). Every head uses every row the
//   CTA loads, so the 16 heads read the cache once. S comes from the grid, the
//   cache's length and the SM count (ops.py split_count), never from a step's
//   values, so one CUDA graph serves every step. The CTA reads its split's mask
//   first and stops at its last valid slot, so a split past its sequence's
//   length reads nothing but the mask; a masked slot inside is zero-filled, not
//   read. With S = 1 the CTA writes the output; with S > 1 a partial (acc, m, l)
//   a head, and latent_attention_combine merges the S partials in split order:
//   no atomics, the same bits run after run. An empty split writes only m and
//   l = 0, which the combine skips.
// - A cp.async ring of kStages stages in shared memory: a stage holds T slots'
//   c_kv and k_pe rows, each thread copying 16-byte pieces, neighbouring
//   threads neighbouring bytes. Rows are padded by 16 bytes so that ldmatrix
//   reads them without bank conflicts.
// - The warps split the latent's R columns, CW each (64 at R 512: 8 warps), and
//   the rope key's dr columns in steps of 16 among the first warps. A warp
//   computes the scores' partial sum over its columns on mma.sync.m16n8k16
//   (A: the 16 heads' q terms, held in registers for the whole walk; B: the
//   stage's rows read with ldmatrix) and writes it to shared memory; after a
//   barrier one thread an entry sums all warps' partials in warp order, and
//   after another every warp reads those sums, so every warp holds the same
//   scores bit for bit. Each warp runs the same online softmax on those
//   fragments (log2 domain), splits P into its three bf16 terms in registers
//   (the score fragments are the A fragments of P . c_kv, as in flash
//   attention) and adds P . c_kv for its own CW columns, B read with
//   ldmatrix.trans from the same stage. The output of each column block stays
//   in its warp's registers; no warp waits on another but at the three barriers
//   a tile.
// - f32 instance: a CTA per (sequence, head, split); a warp takes every fourth
//   slot of the split, a lane R / 32 columns of the row, the score summed by
//   shuffles, an online softmax in every lane. It serves f32 runs held to a
//   forward, not the served model's speed.
// - The host side never synchronises and the kernel allocates nothing: the
//   wrapper allocates out and the partials with torch.empty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kHeads = 16;             // query heads a CTA: the rows of one mma tile
constexpr int kMaxSplitSlots = 16384;  // mask bytes a CTA keeps in shared memory
constexpr float kNegInf = -1e30f;      // finite: exp2(kNegInf - kNegInf) is 1, not NaN
constexpr float kLog2e = 1.4426950408889634f;

// The bf16 kernel's shape at latent width R, rope width DR, CW latent columns a
// warp, T slots a stage and STAGES stages.
template <int R, int DR, int CW, int T, int STAGES>
struct Shape {
  static constexpr int kWarps = R / CW;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCPitch = R + 8;       // elements a c_kv row takes in a stage
  static constexpr int kPPitch = DR + 8;      // and a k_pe row
  static constexpr int kStageBytes = T * (kCPitch + kPPitch) * 2;
  static constexpr int kNT = T / 8;           // score n-tiles (8 slots each) a stage
  static constexpr int kRedBytes = kWarps * kNT * 32 * 16;   // every warp's partial scores
  static constexpr int kCPieces = T * R / 8;  // 16-byte copies of c_kv a stage
  static constexpr int kPPieces = T * DR / 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory; when !live, 16 zeros and no read.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 bf16, b 16 x 8 bf16 (b0, b1), c 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as hi + mid + lo, three bf16 terms whose sum is x exactly (f32's 24 bits
// of significand in three of 8): each remainder is exact in f32.
__device__ __forceinline__ void split3(float x, uint16_t (&t)[3]) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  t[0] = __bfloat16_as_ushort(hi);
  t[1] = __bfloat16_as_ushort(mid);
  t[2] = __bfloat16_as_ushort(lo);
}

// An mma A fragment register of each term from two f32 values (a in the low half).
__device__ __forceinline__ void pack3(float a, float b, uint32_t (&out)[3]) {
  uint16_t ta[3], tb[3];
  split3(a, ta);
  split3(b, tb);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = static_cast<uint32_t>(ta[i]) | (static_cast<uint32_t>(tb[i]) << 16);
}

template <int R, int DR, int CW, int T, int STAGES>
__global__ void __launch_bounds__(Shape<R, DR, CW, T, STAGES>::kThreads)
latent_attention_kernel(const float* __restrict__ q_lat, const __nv_bfloat16* __restrict__ q_pe,
                        const __nv_bfloat16* __restrict__ c_kv,
                        const __nv_bfloat16* __restrict__ k_pe,
                        const uint8_t* __restrict__ valid, float* __restrict__ out,
                        float* __restrict__ partial, int H, int length, int per_split,
                        float scale_log2) {
  using Sh = Shape<R, DR, CW, T, STAGES>;
  constexpr int NW = Sh::kWarps, NT = Sh::kNT, KS = CW / 16, NC = CW / 8, PE = DR / 16;
  constexpr int CP = Sh::kCPitch, PP = Sh::kPPitch, kRow = R + 2;
  static_assert(CW % 16 == 0 && T % 16 == 0 && DR % 16 == 0 && PE <= NW, "tile shapes");
  static_assert(Sh::kCPieces % Sh::kThreads == 0 && Sh::kPPieces % Sh::kThreads == 0,
                "every thread copies as many pieces");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int live_end;                    // one past the split's last valid slot
  const int groups = (H + kHeads - 1) / kHeads;
  const int b = blockIdx.x / groups, h_first = (blockIdx.x % groups) * kHeads;
  const int split = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;      // mma fragments: row, column pair
  unsigned char* ring = smem;
  float4* red = reinterpret_cast<float4*>(smem + STAGES * Sh::kStageBytes);
  uint8_t* live_s = smem + STAGES * Sh::kStageBytes + Sh::kRedBytes;   // the split's mask
  const int first = split * per_split;
  const int rows = max(0, min(length, first + per_split) - first);
  const int h0 = h_first + g, h1 = h0 + 8;    // this lane's two heads

  // the split's mask into shared memory, and where its valid slots end
  if (tid == 0) live_end = 0;
  __syncthreads();
  const uint8_t* valid_b = valid + (long)b * length + first;
  int end = 0;
  for (int i = tid; i < rows; i += Sh::kThreads) {
    const uint8_t v = valid_b[i];
    live_s[i] = v;
    if (v) end = i + 1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) end = max(end, __shfl_xor_sync(0xffffffffu, end, o));
  if (lane == 0 && end > 0) atomicMax(&live_end, end);   // a max: the order does not matter
  __syncthreads();
  const int n_live = live_end;
  const int tiles = (n_live + T - 1) / T;

  if (tiles == 0) {                           // nothing valid: an empty partial, or zeros
    if (S == 1) {
      for (int i = tid; i < kHeads * R; i += Sh::kThreads) {
        const int h = h_first + i / R;
        if (h < H) out[((long)b * H + h) * R + i % R] = 0.f;
      }
    } else if (tid < kHeads && h_first + tid < H) {
      float* row = partial + (((long)b * H + h_first + tid) * S + split) * kRow;
      row[R] = kNegInf;
      row[R + 1] = 0.f;
    }
    return;
  }

  const int col0 = warp * CW;                 // this warp's latent columns
  // q_lat's A fragments over this warp's columns, as three bf16 terms:
  // a0 (row g, k 2t..2t+1), a1 (row g + 8), a2 (row g, k 2t+8..), a3 (row g + 8)
  uint32_t qa[KS][3][4];
  {
    const float* q0 = q_lat + ((long)b * H + min(h0, H - 1)) * R + col0 + 2 * t;
    const float* q1 = q_lat + ((long)b * H + min(h1, H - 1)) * R + col0 + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 x00 = h0 < H ? *reinterpret_cast<const float2*>(q0 + ks * 16) : float2{0.f, 0.f};
      const float2 x10 = h1 < H ? *reinterpret_cast<const float2*>(q1 + ks * 16) : float2{0.f, 0.f};
      const float2 x01 = h0 < H ? *reinterpret_cast<const float2*>(q0 + ks * 16 + 8) : float2{0.f, 0.f};
      const float2 x11 = h1 < H ? *reinterpret_cast<const float2*>(q1 + ks * 16 + 8) : float2{0.f, 0.f};
      uint32_t p[3];
      pack3(x00.x, x00.y, p);
#pragma unroll
      for (int i = 0; i < 3; ++i) qa[ks][i][0] = p[i];
      pack3(x10.x, x10.y, p);
#pragma unroll
      for (int i = 0; i < 3; ++i) qa[ks][i][1] = p[i];
      pack3(x01.x, x01.y, p);
#pragma unroll
      for (int i = 0; i < 3; ++i) qa[ks][i][2] = p[i];
      pack3(x11.x, x11.y, p);
#pragma unroll
      for (int i = 0; i < 3; ++i) qa[ks][i][3] = p[i];
    }
  }
  // q_pe's A fragment for the rope key's columns [16 warp, 16 warp + 16), bf16 as it is
  uint32_t qp[4] = {0u, 0u, 0u, 0u};
  if (warp < PE) {
    const __nv_bfloat16* p0 = q_pe + ((long)b * H + min(h0, H - 1)) * DR + warp * 16 + 2 * t;
    const __nv_bfloat16* p1 = q_pe + ((long)b * H + min(h1, H - 1)) * DR + warp * 16 + 2 * t;
    if (h0 < H) {
      qp[0] = *reinterpret_cast<const uint32_t*>(p0);
      qp[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    }
    if (h1 < H) {
      qp[1] = *reinterpret_cast<const uint32_t*>(p1);
      qp[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
    }
  }

  const __nv_bfloat16* c0 = c_kv + ((long)b * length + first) * R;
  const __nv_bfloat16* k0 = k_pe + ((long)b * length + first) * DR;
  // tile st's rows into ring slot st % STAGES: T rows of c_kv (pitch CP), then T
  // of k_pe (pitch PP); a slot the mask leaves out, or past the valid end, is
  // zero-filled and not read
  auto load_stage = [&](int st) {
    unsigned char* dst = ring + (st % STAGES) * Sh::kStageBytes;
#pragma unroll
    for (int i = 0; i < Sh::kCPieces / Sh::kThreads; ++i) {
      const int p = tid + i * Sh::kThreads;
      const int r = p / (R / 8), part = p % (R / 8);
      const int j = st * T + r;
      const bool live = j < n_live && live_s[j] != 0;
      copy16(dst + (r * CP + part * 8) * 2, c0 + (long)(live ? j : 0) * R + part * 8, live);
    }
#pragma unroll
    for (int i = 0; i < Sh::kPPieces / Sh::kThreads; ++i) {
      const int p = tid + i * Sh::kThreads;
      const int r = p / (DR / 8), part = p % (DR / 8);
      const int j = st * T + r;
      const bool live = j < n_live && live_s[j] != 0;
      copy16(dst + (T * CP + r * PP + part * 8) * 2, k0 + (long)(live ? j : 0) * DR + part * 8,
             live);
    }
  };

  float acc[NC][4];                           // 16 heads x this warp's CW columns
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g, g + 8; l: this lane's part

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < tiles) load_stage(st);
    commit_group();
  }
  for (int it = 0; it < tiles; ++it) {
    wait_groups<STAGES - 2>();   // this thread's copies of tile it have landed
    __syncthreads();             // everyone's have; tile it - 1 and the partials are read
    if (it + STAGES - 1 < tiles) load_stage(it + STAGES - 1);
    commit_group();
    const __nv_bfloat16* Cs =
        reinterpret_cast<const __nv_bfloat16*>(ring + (it % STAGES) * Sh::kStageBytes);
    const __nv_bfloat16* Ps = Cs + T * CP;

    // this warp's part of the scores, 16 heads x T slots: q terms against the rows
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Cs + (np * 16 + (lane & 7) + (lane >> 4) * 8) * CP + col0 + ks * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma_bf16(s[2 * np], qa[ks][i], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qa[ks][i], r[2], r[3]);
        }
      }
    }
    if (warp < PE) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Ps + (np * 16 + (lane & 7) + (lane >> 4) * 8) * PP + warp * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qp, r[0], r[1]);
        mma_bf16(s[2 * np + 1], qp, r[2], r[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      red[(warp * NT + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    __syncthreads();

    // the whole scores: a thread an entry sums the warps' partials in warp order
    // once, into warp 0's place, and every warp reads the same sums back
    for (int e = tid; e < NT * 32; e += Sh::kThreads) {
      float4 a = red[e];
#pragma unroll
      for (int w = 1; w < NW; ++w) {
        const float4 x = red[w * NT * 32 + e];
        a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      }
      red[e] = a;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 a = red[n * 32 + lane];
      s[n][0] = a.x; s[n][1] = a.y; s[n][2] = a.z; s[n][3] = a.w;
    }
    bool on[NT][2];                           // slots n * 8 + 2t and + 1
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = it * T + n * 8 + 2 * t + e;
        on[n][e] = j < n_live && live_s[j] != 0;
      }
    // online softmax on the fragments: row g (e 0, 1), row g + 8 (e 2, 3); the
    // four lanes of a quad share a row
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[n][2 * rr + e] *= scale_log2;
          if (on[n][e]) mx = fmaxf(mx, s[n][2 * rr + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float corr = exp2f(m[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = on[n][e] ? exp2f(s[n][2 * rr + e] - m_new) : 0.f;
          s[n][2 * rr + e] = p;
          sum += p;
        }
      l[rr] = l[rr] * corr + sum;
      m[rr] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        acc[n][2 * rr] *= corr;
        acc[n][2 * rr + 1] *= corr;
      }
    }

    // O += P . c_kv over this warp's columns: two score n-tiles are one A
    // fragment of a 16-slot k step, P in three bf16 terms
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t pa[3][4], p[3];
      pack3(s[2 * kk][0], s[2 * kk][1], p);
#pragma unroll
      for (int i = 0; i < 3; ++i) pa[i][0] = p[i];
      pack3(s[2 * kk][2], s[2 * kk][3], p);
#pragma unroll
      for (int i = 0; i < 3; ++i) pa[i][1] = p[i];
      pack3(s[2 * kk + 1][0], s[2 * kk + 1][1], p);
#pragma unroll
      for (int i = 0; i < 3; ++i) pa[i][2] = p[i];
      pack3(s[2 * kk + 1][2], s[2 * kk + 1][3], p);
#pragma unroll
      for (int i = 0; i < 3; ++i) pa[i][3] = p[i];
#pragma unroll
      for (int dp = 0; dp < CW / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Cs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * CP + col0 +
                                 dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma_bf16(acc[2 * dp], pa[i], r[0], r[1]);
          mma_bf16(acc[2 * dp + 1], pa[i], r[2], r[3]);
        }
      }
    }
  }
  wait_groups<0>();

  // each row's l over its quad; every warp holds the same m and l
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int h = rr ? h1 : h0;
    if (h >= H) continue;
    if (S == 1) {
      const float inv = 1.f / fmaxf(l[rr], 1e-30f);
      float* dst = out + ((long)b * H + h) * R + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NC; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(acc[n][2 * rr] * inv, acc[n][2 * rr + 1] * inv);
    } else {
      float* row = partial + (((long)b * H + h) * S + split) * kRow;
#pragma unroll
      for (int n = 0; n < NC; ++n)
        *reinterpret_cast<float2*>(row + col0 + n * 8 + 2 * t) =
            make_float2(acc[n][2 * rr], acc[n][2 * rr + 1]);
      if (warp == 0 && t == 0) {
        row[R] = m[rr];
        row[R + 1] = l[rr];
      }
    }
  }
}

constexpr int kF32Warps = 4;

// f32: a CTA per (sequence, head, split), a warp every kF32Warps-th slot, a lane
// columns lane, lane + 32, ... of its row.
template <int R, int DR>
__global__ void __launch_bounds__(32 * kF32Warps)
latent_attention_f32_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_pe,
                            const float* __restrict__ c_kv, const float* __restrict__ k_pe,
                            const uint8_t* __restrict__ valid, float* __restrict__ out,
                            float* __restrict__ partial, int H, int length, int per_split,
                            float scale_log2) {
  constexpr int ER = (R + 31) / 32, EP = (DR + 31) / 32, kRow = R + 2;
  __shared__ float merge[kF32Warps * kRow];
  const int bh = blockIdx.x, b = bh / H;
  const int split = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = split * per_split, last = min(length, first + per_split);
  const uint8_t* valid_b = valid + (long)b * length;

  float qr[ER], qp[EP], acc[ER];
#pragma unroll
  for (int e = 0; e < ER; ++e) {
    const int c = e * 32 + lane;
    qr[e] = c < R ? q_lat[(long)bh * R + c] : 0.f;
    acc[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    const int c = e * 32 + lane;
    qp[e] = c < DR ? q_pe[(long)bh * DR + c] : 0.f;
  }
  float m = kNegInf, l = 0.f;
  for (int j = first + warp; j < last; j += kF32Warps) {
    if (!valid_b[j]) continue;                // the whole warp skips the slot
    const float* crow = c_kv + ((long)b * length + j) * R;
    const float* prow = k_pe + ((long)b * length + j) * DR;
    float cx[ER], s = 0.f;
#pragma unroll
    for (int e = 0; e < ER; ++e) {
      const int c = e * 32 + lane;
      cx[e] = c < R ? crow[c] : 0.f;
      s = fmaf(qr[e], cx[e], s);
    }
#pragma unroll
    for (int e = 0; e < EP; ++e) {
      const int c = e * 32 + lane;
      s = fmaf(qp[e], c < DR ? prow[c] : 0.f, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s *= scale_log2;
    const float m_new = fmaxf(m, s);
    const float corr = exp2f(m - m_new), p = exp2f(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int e = 0; e < ER; ++e) acc[e] = fmaf(p, cx[e], acc[e] * corr);
    m = m_new;
  }
  float* mine = merge + warp * kRow;
#pragma unroll
  for (int e = 0; e < ER; ++e) {
    const int c = e * 32 + lane;
    if (c < R) mine[c] = acc[e];
  }
  if (lane == 0) {
    mine[R] = m;
    mine[R + 1] = l;
  }
  __syncthreads();
  float mm = kNegInf;
#pragma unroll
  for (int w = 0; w < kF32Warps; ++w) mm = fmaxf(mm, merge[w * kRow + R]);
  for (int c = tid; c < R; c += 32 * kF32Warps) {
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) {
      const float* row = merge + w * kRow;
      if (row[R + 1] > 0.f) {                 // a warp that met no valid slot adds nothing
        const float f = exp2f(row[R] - mm);
        ll += row[R + 1] * f;
        aa += row[c] * f;
      }
    }
    if (S == 1) {
      out[(long)bh * R + c] = aa / fmaxf(ll, 1e-30f);
    } else {
      float* row = partial + ((long)bh * S + split) * kRow;
      row[c] = aa;
      if (c == 0) {
        row[R] = ll > 0.f ? mm : kNegInf;
        row[R + 1] = ll;
      }
    }
  }
}

// Merge each (sequence, head)'s S partials in split order: one CTA each. A
// split with l = 0 met no valid slot and wrote nothing else: it is skipped.
__global__ void __launch_bounds__(128)
latent_attention_combine(const float* __restrict__ partial, float* __restrict__ out, int R,
                         int S) {
  const int bh = blockIdx.x, row = R + 2;
  const float* p = partial + (long)bh * S * row;
  float mm = kNegInf;
  for (int s = 0; s < S; ++s)
    if (p[(long)s * row + R + 1] > 0.f) mm = fmaxf(mm, p[(long)s * row + R]);
  for (int c = threadIdx.x; c < R; c += blockDim.x) {
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* ps = p + (long)s * row;
      const float ls = ps[R + 1];
      if (ls > 0.f) {
        const float f = exp2f(ps[R] - mm);
        ll += ls * f;
        aa += ps[c] * f;
      }
    }
    out[(long)bh * R + c] = aa / fmaxf(ll, 1e-30f);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

std::mutex g_mutex;

// The bf16 instances' shapes: CW latent columns a warp, T slots a stage, stages.
constexpr int kT = 32, kStages = 2;

template <int R, int DR, int CW>
int launch_bf16(const void* q_lat, const void* q_pe, const void* c_kv, const void* k_pe,
                const void* valid, void* out, void* partial, int B, int H, int length, int S,
                float scale, cudaStream_t stream) {
  using Sh = Shape<R, DR, CW, kT, kStages>;
  auto kernel = latent_attention_kernel<R, DR, CW, kT, kStages>;
  const int per = (length + S - 1) / S;
  const int smem = kStages * Sh::kStageBytes + Sh::kRedBytes + ((per + 15) & ~15);
  static int smem_set = 0;             // the largest size allowed so far
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (smem > smem_set) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = smem;
    }
  }
  using bf16 = __nv_bfloat16;
  const int groups = (H + kHeads - 1) / kHeads;
  kernel<<<dim3(B * groups, S), Sh::kThreads, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const bf16*>(q_pe),
      static_cast<const bf16*>(c_kv), static_cast<const bf16*>(k_pe),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out),
      static_cast<float*>(partial), H, length, per, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int DR>
int launch_f32(const void* q_lat, const void* q_pe, const void* c_kv, const void* k_pe,
               const void* valid, void* out, void* partial, int B, int H, int length, int S,
               float scale, cudaStream_t stream) {
  latent_attention_f32_kernel<R, DR><<<dim3(B * H, S), 32 * kF32Warps, 0, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
      static_cast<const float*>(c_kv), static_cast<const float*>(k_pe),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out),
      static_cast<float*>(partial), H, length, (length + S - 1) / S, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The kernel, then with S > 1 the combine into out.
template <int R, int DR, int CW>
int launch(bool f32, const void* q_lat, const void* q_pe, const void* c_kv, const void* k_pe,
           const void* valid, void* out, void* partial, int B, int H, int length, int S,
           float scale, cudaStream_t stream) {
  const int err = f32 ? launch_f32<R, DR>(q_lat, q_pe, c_kv, k_pe, valid, out, partial, B, H,
                                          length, S, scale, stream)
                      : launch_bf16<R, DR, CW>(q_lat, q_pe, c_kv, k_pe, valid, out, partial, B,
                                               H, length, S, scale, stream);
  if (err != 0 || S == 1) return err;
  latent_attention_combine<<<B * H, 128, 0, stream>>>(static_cast<const float*>(partial),
                                                      static_cast<float*>(out), R, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_lat, out: (B, H, R) f32; q_pe (B, H, dr), c_kv (B, length, R), k_pe (B,
// length, dr): all bf16 (f32 = 0) or all f32 (f32 = 1); valid: (B, length)
// bytes. splits: S, each taking ceil(length / S) slots (at most
// kMaxSplitSlots); with S > 1, `partial` holds B*H*S*(R+2) floats. (R, dr)
// must be an instance: (512, 64) or (32, 16). Returns 0 once launched, else a
// cudaError_t.
extern "C" int latent_attention_fwd(const void* q_lat, const void* q_pe, const void* c_kv,
                                    const void* k_pe, const void* valid, void* out,
                                    void* partial, int B, int H, int R, int DR, int length,
                                    int splits, int f32, float scale, void* stream) {
  if (B <= 0 || H <= 0 || length <= 0 || splits <= 0 || splits > length ||
      (length + splits - 1) / splits > kMaxSplitSlots || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch<512, 64, 64>) fn = R == 512 && DR == 64 ? launch<512, 64, 64>
                                      : R == 32 && DR == 16 ? launch<32, 16, 16>
                                                            : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(f32 != 0, q_lat, q_pe, c_kv, k_pe, valid, out, partial, B, H, length, splits, scale,
            static_cast<cudaStream_t>(stream));
}
