// Decode attention over a dense ring of K/V slots for Hopper (sm_90a): one
// query token a sequence, the sliding-window archs' decode (hymba-1.5b).
//
// Replaces no TPU kernel. The reference decodes its ring with plain products
// (src/repro/models/attention.py attention_decode), and so did the port's
// RingKVCache.attend: every layer cast the whole ring to f32, let einsum lay it
// out again for two f32 batched products of G rows, and masked and softmaxed
// the scores between them: some 400 MB of traffic a layer at hymba-1.5b's
// B 64, through copy kernels far below bandwidth. This kernel computes the
// same function (ring_attention_plain, kernels/ring_attention/ops.py) and
// reads each cached byte once, in bf16.
//
// Function: for each sequence b and query head h = kh*G + g (G = H / Kh),
//   s_j = (q[b,h] . K[b,j,kh]) * scale    over the slots j with valid[b,j]
//   out[b,h] = sum_j softmax(s)_j V[b,j,kh]
// at the plain version's precision. bf16 (the served models): the products
// q.K of bf16 operands are exact and summed in f32, the softmax is f32, V is
// widened exactly from bf16 and P.V is summed in f32; P is never rounded
// below f32. f32 (an f32 copy of a model, held to a forward in f32): every
// product and sum in f32 on the CUDA cores. Only the order of the sums
// differs from the plain version's. A sequence with no valid slot gets zeros
// (the plain version's softmax would be uniform there; a step's plan always
// holds the step's own slot).
//
// Instances (D, G): (64, 5) hymba-1.5b, (32, 2) its reduced copy, (128, 8)
// the largest head and group, which the edge-case tests run; bf16 and f32
// each. Any other shape or dtype is refused (cudaErrorInvalidValue; the
// wrapper raises before).
//
// Layouts (all contiguous):
//   q        (B, H, D)            bf16 or f32
//   k, v     (B, length, Kh, D)   q's dtype: one layer's slices of the ring's buffers
//   valid    (B, length)          bool, one byte a slot: the step plan's mask
//   out      (B, H, D)            q's dtype
//   partial  (B*Kh, S, G, D + 2)  f32 scratch, only when S > 1
//
// Bound on this card: bytes. A step reads every layer's ring once: at
// hymba-1.5b's decode (B 64, 1024 slots, Kh 5, D 64) 83.9 MB a layer, 25 us at
// 3.35 TB/s, against 4*D*H flops a slot (about 5 flops a byte, 0.42 GFLOP a
// layer). Yet the flops are not free: at 3.35 TB/s the SM must spend about two
// instructions a clock on them if q.K, its shuffles and a per-row softmax all
// run on the CUDA cores (a first design read 1.42 TB/s so). The design keeps
// the instructions a byte low.
//
// Design.
// - Grid (B*Kh, S): a CTA takes one (sequence, KV head) and split s of its
//   slots, [s*per, (s+1)*per). All G query heads of the KV head use every row
//   it loads, so the GQA group never reads the cache twice. S comes from B*Kh,
//   the ring's length and the SM count (ops.py split_count), never from a
//   step's values, so one CUDA graph serves every step. With S = 1 the CTA
//   writes the output; with S > 1 it writes a partial (m, l, acc) per head
//   and ring_attention_combine merges the S partials in a fixed order: no
//   atomics, the same bits run after run.
// - A cp.async ring of kStages stages in shared memory: a stage holds C =
//   kWarps * kTilesPerWarp * 16 rows of K and of V, each thread copying
//   16-byte pieces, neighbouring threads neighbouring bytes, so kStages - 1
//   stages are in flight while one is read. K rows are padded by 16 bytes so
//   that ldmatrix reads them without bank conflicts. The CTA's valid bytes
//   are read into shared memory while the first kStages - 1 stages (copied
//   whole) are in flight; from then on a masked slot's copy is a zero-fill
//   that reads nothing, so a ring not yet full moves little more than its
//   live rows.
// - S = K q^T on the tensor cores: a warp takes 16 rows at a time, one
//   mma.sync.m16n8k16 (bf16 in, f32 out) for every 16 of D, the G query
//   heads as the 8 columns of B (zero past G). The online softmax runs on
//   the score fragments, one running max a column shared by the warp (three
//   shuffles a tile), in the log2 domain.
// - P.V on the CUDA cores in f32: the warp writes the tile's P (16 x 8 f32)
//   and the columns' corrections to its own 544 bytes of shared memory; L =
//   D / 8 lanes then hold a 16-byte slice of a V row (8 bf16, widened), so a
//   warp instruction covers 32 / L rows, each lane group adding p * v for all
//   G heads into f32 registers. The warp's groups add up once, at the end;
//   the warps merge through shared memory.
// - f32: the same grid, partials and combine; a warp takes every kWarps-th
//   slot of the split, a lane D / 32 consecutive elements of its K and V rows
//   (a row is one coalesced read), the G scores summed by shuffles, one online
//   softmax a head in every lane. It serves f32 runs held to a forward, not
//   the served models' speed.
// - What bounds it (tools/kernel_variants.py ring, H100 80GB HBM3 at 700 W,
//   1024 slots, hymba-1.5b's heads): at B 64 the copy. With the compute cut
//   out the kernel takes 91 % of its time (34.4 of 37.8 us, 2.4 TB/s); two or
//   four stages and an L2 prefetch hint measured no faster, two or four splits
//   slower (48.5, 47.0 us with the combine). At B 1 to 16 there are too few
//   CTAs to fill the card and splits pay: B 4 takes 17.1 us at S 1, 12.1 at
//   S 4, 14.1 at S 8 (ops.py split_count picks 4 there, 1 at B 64).
// - The host side never synchronises and the kernel allocates nothing: the
//   wrapper allocates out and the partials with torch.empty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;             // ring depth: two stages in flight while one is read
constexpr int kTilesPerWarp = 1;       // 16-row tiles a warp takes from each stage
constexpr int kPBuf = 16 * 8 + 8;      // floats a warp's P tile and corrections take
constexpr int kMaxSplitSlots = 32768;  // valid bytes a CTA keeps in shared memory
constexpr float kNegInf = -1e30f;      // finite: exp2(kNegInf - kNegInf) is 1, not NaN
constexpr float kLog2e = 1.4426950408889634f;

// A stage's shape at head dim D: its rows, the K rows' pitch in elements, its bytes.
template <int D>
struct Stage {
  static constexpr int kRows = kWarps * kTilesPerWarp * 16;
  static constexpr int kKPitch = D + 8;
  static constexpr int kBytes = kRows * (kKPitch + D) * 2;
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

// The A fragments of a 16 x 16 bf16 tile: lane l gives the address of row
// (l % 8) + 8 * ((l / 8) % 2), columns 8 * (l / 16) on.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 bf16 (rows of K), b 16 x 8 bf16 (q, a column a head), c f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 bf16 as f32: bf16 -> f32 is a shift into the high half.
__device__ __forceinline__ void widen8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
ring_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int length,
                      int Kh, int per_split, float scale_log2) {
  using Shape = Stage<D>;
  constexpr int L = D / 8;                    // lanes a V row in P.V
  constexpr int RW = 32 / L;                  // V rows one warp instruction covers
  constexpr int C = Shape::kRows, KP = Shape::kKPitch;
  constexpr int kPieces = 2 * C * L;          // 16-byte copies a stage
  constexpr int kRow = D + 2;                 // a merge row: acc[D], m, l
  static_assert(kPieces % kThreads == 0, "every thread copies as many pieces");
  static_assert(kWarps * G * kRow * 4 <= kStages * Shape::kBytes, "the merge fits the ring");

  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / Kh, kh = blockIdx.x % Kh;
  const int split = blockIdx.y, S = gridDim.y;
  const int H = Kh * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* ring = smem;
  float* pbuf = reinterpret_cast<float*>(smem + kStages * Shape::kBytes) + warp * kPBuf;
  uint8_t* live_s = smem + kStages * Shape::kBytes + kWarps * kPBuf * 4;   // the split's mask
  float* merge = reinterpret_cast<float*>(smem);                          // the drained ring
  const int grp = lane / L, sub = lane % L;   // P.V: a V row's lane group, 16 bytes of it
  const int qr = lane >> 2, qc = 2 * (lane & 3);   // mma fragments: row, first column
  const int first = split * per_split;
  const int rows = max(0, min(length, first + per_split) - first);
  const int stages = (rows + C - 1) / C;

  const long step = (long)Kh * D;                   // elements from a slot to the next
  const long base_off = ((long)b * length + first) * step + (long)kh * D;
  const __nv_bfloat16* k0 = k + base_off;
  const __nv_bfloat16* v0 = v + base_off;

  // stage st's rows into ring slot st % kStages: C rows of K (pitch KP), then C of V
  // (pitch D); with `masked`, a slot the mask leaves out is zero-filled, not read
  auto load_stage = [&](int st, bool masked) {
    unsigned char* dst = ring + (st % kStages) * Shape::kBytes;
#pragma unroll
    for (int i = 0; i < kPieces / kThreads; ++i) {
      const int p = tid + i * kThreads;
      const int which = p / (C * L), r = (p / L) % C, part = p % L;
      const int j = st * C + r;
      const bool live = j < rows && (!masked || live_s[j] != 0);
      const __nv_bfloat16* src = (which ? v0 : k0) + (live ? j : 0) * step + part * 8;
      const int off = which ? C * KP * 2 + (r * D + part * 8) * 2 : (r * KP + part * 8) * 2;
      copy16(dst + off, src, live);
    }
  };

  // q as the mma's B operand (k = d, n = query head): column qr of the group, zero past G
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* qrow = q + ((long)b * H + kh * G + qr) * D + ks * 16 + qc;
    qb[ks][0] = qr < G ? *reinterpret_cast<const uint32_t*>(qrow) : 0u;
    qb[ks][1] = qr < G ? *reinterpret_cast<const uint32_t*>(qrow + 8) : 0u;
  }
  // the online softmax, per query column, shared by the warp (log2 domain): this
  // lane keeps m of columns qc, qc + 1 and its own rows' part of their l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;

  // the first stages go out before the mask is read, whole: its read then overlaps them
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < stages) load_stage(st, false);
    commit_group();
  }
  const uint8_t* valid_b = valid + (long)b * length + first;
  for (int i = tid; i < rows; i += kThreads) live_s[i] = valid_b[i];
  for (int st = 0; st < stages; ++st) {
    wait_groups<kStages - 2>();   // this thread's copies of stage st have landed
    __syncthreads();              // everyone's have, the mask is in, stage st - 1 is read
    if (st + kStages - 1 < stages) load_stage(st + kStages - 1, true);
    commit_group();
    const unsigned char* Ks = ring + (st % kStages) * Shape::kBytes;
    const __nv_bfloat16* Vs = reinterpret_cast<const __nv_bfloat16*>(Ks + C * KP * 2);
#pragma unroll
    for (int t = 0; t < kTilesPerWarp; ++t) {
      const int tb = (warp * kTilesPerWarp + t) * 16;   // the tile's first row in the stage
      // S = K q^T for 16 rows: bf16 products, exact, summed in f32
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int row = tb + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t a[4];
        ldmatrix_x4(a, Ks + (row * KP + ks * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(c, a, qb[ks]);
      }
      const int r0 = st * C + tb + qr, r1 = r0 + 8;     // this lane's rows in the split
      const bool on0 = r0 < rows && live_s[r0] != 0, on1 = r1 < rows && live_s[r1] != 0;
      float s[4] = {on0 ? c[0] * scale_log2 : kNegInf, on0 ? c[1] * scale_log2 : kNegInf,
                    on1 ? c[2] * scale_log2 : kNegInf, on1 ? c[3] * scale_log2 : kNegInf};
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {                     // column qc + h
        float mx = fmaxf(s[h], s[2 + h]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[h], mx);
        corr[h] = exp2f(m[h] - m_new);
        s[h] = on0 ? exp2f(s[h] - m_new) : 0.f;
        s[2 + h] = on1 ? exp2f(s[2 + h] - m_new) : 0.f;
        l[h] = l[h] * corr[h] + s[h] + s[2 + h];
        m[h] = m_new;
      }
      // P (16 rows x 8 columns, f32) and the columns' corrections to the warp's buffer
      *reinterpret_cast<float2*>(pbuf + qr * 8 + qc) = make_float2(s[0], s[1]);
      *reinterpret_cast<float2*>(pbuf + (qr + 8) * 8 + qc) = make_float2(s[2], s[3]);
      if (lane < 4) *reinterpret_cast<float2*>(pbuf + 16 * 8 + qc) = make_float2(corr[0], corr[1]);
      __syncwarp();
      // O = O * corr + P V on the CUDA cores, in f32: lane group grp takes rows grp, grp + RW, ...
      float cf[8];
      load8(pbuf + 16 * 8, cf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= cf[g];
#pragma unroll
      for (int i = 0; i < 16 / RW; ++i) {
        const int row = i * RW + grp;
        float p[8], vx[8];
        load8(pbuf + row * 8, p);
        widen8(Vs + (tb + row) * D + sub * 8, vx);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p[g], vx[e], acc[g][e]);
      }
      __syncwarp();                                     // P is read before the next tile's
    }
  }
  wait_groups<0>();
  __syncthreads();   // the ring is drained: its memory holds the merge from here

  // the warp's state: its lane groups' acc summed (one m per column), each
  // column's l summed over its 8 lanes
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* row = merge + (warp * G + g) * kRow;
#pragma unroll
      for (int e = 0; e < 8; ++e) row[sub * 8 + e] = acc[g][e];
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (qc + h < G) {
        float* row = merge + (warp * G + qc + h) * kRow;
        row[D] = m[h];
        row[D + 1] = l[h];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, merge[(w * G + g) * kRow + D]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = merge + (w * G + g) * kRow;
      const float c = exp2f(row[D] - mm);
      ll += row[D + 1] * c;
      aa += row[d] * c;
    }
    if (S == 1) {
      out[((long)b * H + kh * G + g) * D + d] = __float2bfloat16(aa / fmaxf(ll, 1e-30f));
    } else {
      float* row = partial + (((long)blockIdx.x * S + split) * G + g) * kRow;
      row[d] = aa;
      if (d == 0) { row[D] = mm; row[D + 1] = ll; }
    }
  }
}

template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[E]) {
  if constexpr (E == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (E == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
ring_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const uint8_t* __restrict__ valid,
                          float* __restrict__ out, float* __restrict__ partial, int length,
                          int Kh, int per_split, float scale_log2) {
  constexpr int E = D / 32;                   // elements of a row a lane takes
  constexpr int kRow = D + 2;                 // a merge row: acc[D], m, l
  __shared__ float merge[kWarps * G * kRow];
  const int b = blockIdx.x / Kh, kh = blockIdx.x % Kh;
  const int split = blockIdx.y, S = gridDim.y;
  const int H = Kh * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = split * per_split, last = min(length, first + per_split);
  const long step = (long)Kh * D;
  const long base_off = (long)b * length * step + (long)kh * D + lane * E;
  const uint8_t* valid_b = valid + (long)b * length;

  float qr[G][E], m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_f32<E>(q + ((long)b * H + kh * G + g) * D + lane * E, qr[g]);
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  for (int j = first + warp; j < last; j += kWarps) {
    if (!valid_b[j]) continue;                // the whole warp skips the slot
    float kx[E], vx[E];
    load_f32<E>(k + base_off + j * step, kx);
    load_f32<E>(v + base_off + j * step, vx);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(qr[g][e], kx[e], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      s *= scale_log2;
      const float m_new = fmaxf(m[g], s);
      const float corr = exp2f(m[g] - m_new), p = exp2f(s - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e] * corr);
      m[g] = m_new;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* row = merge + (warp * G + g) * kRow;
#pragma unroll
    for (int e = 0; e < E; ++e) row[lane * E + e] = acc[g][e];
    if (lane == 0) { row[D] = m[g]; row[D + 1] = l[g]; }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, merge[(w * G + g) * kRow + D]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = merge + (w * G + g) * kRow;
      const float c = exp2f(row[D] - mm);
      ll += row[D + 1] * c;
      aa += row[d] * c;
    }
    if (S == 1) {
      out[((long)b * H + kh * G + g) * D + d] = aa / fmaxf(ll, 1e-30f);
    } else {
      float* row = partial + (((long)blockIdx.x * S + split) * G + g) * kRow;
      row[d] = aa;
      if (d == 0) { row[D] = mm; row[D + 1] = ll; }
    }
  }
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Merge the S partials of each (sequence, KV head), in split order: one CTA each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_attention_combine(const float* __restrict__ partial, T* __restrict__ out, int Kh, int G,
                       int D, int S) {
  const int bk = blockIdx.x, b = bk / Kh, kh = bk % Kh, H = Kh * G, row = D + 2;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    const float* p = partial + ((long)bk * S * G + g) * row;
    float mm = kNegInf;
    for (int s = 0; s < S; ++s) mm = fmaxf(mm, p[(long)s * G * row + D]);
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* ps = p + (long)s * G * row;
      const float c = exp2f(ps[D] - mm);
      ll += ps[D + 1] * c;
      aa += ps[d] * c;
    }
    store(out + ((long)b * H + kh * G + g) * D + d, aa / fmaxf(ll, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

std::mutex g_mutex;

template <int D, int G>
int launch_bf16(const void* q, const void* k, const void* v, const void* valid, void* out,
                void* partial, int B, int Kh, int length, int S, float scale,
                cudaStream_t stream) {
  const int per = (length + S - 1) / S;
  const int smem = kStages * Stage<D>::kBytes + kWarps * kPBuf * 4 + ((per + 15) & ~15);
  static int smem_set = 0;             // the largest size allowed so far
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (smem > smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          ring_attention_kernel<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = smem;
    }
  }
  using bf16 = __nv_bfloat16;
  ring_attention_kernel<D, G><<<dim3(B * Kh, S), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(out),
      static_cast<float*>(partial), length, Kh, per, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int G>
int launch_f32(const void* q, const void* k, const void* v, const void* valid, void* out,
               void* partial, int B, int Kh, int length, int S, float scale,
               cudaStream_t stream) {
  ring_attention_f32_kernel<D, G><<<dim3(B * Kh, S), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out),
      static_cast<float*>(partial), length, Kh, (length + S - 1) / S, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The kernel, then with S > 1 the combine into out.
template <int D, int G>
int launch(bool f32, const void* q, const void* k, const void* v, const void* valid, void* out,
           void* partial, int B, int Kh, int length, int S, float scale, cudaStream_t stream) {
  const int err = f32 ? launch_f32<D, G>(q, k, v, valid, out, partial, B, Kh, length, S, scale,
                                         stream)
                      : launch_bf16<D, G>(q, k, v, valid, out, partial, B, Kh, length, S, scale,
                                          stream);
  if (err != 0 || S == 1) return err;
  const float* part = static_cast<const float*>(partial);
  if (f32)
    ring_attention_combine<<<B * Kh, kThreads, 0, stream>>>(part, static_cast<float*>(out), Kh,
                                                            G, D, S);
  else
    ring_attention_combine<<<B * Kh, kThreads, 0, stream>>>(
        part, static_cast<__nv_bfloat16*>(out), Kh, G, D, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, H, D); k, v: one layer's (B, length, Kh, D) ring, all bf16
// (f32 = 0) or all f32 (f32 = 1); valid: (B, length) bytes. splits: S, each
// taking ceil(length / S) slots (at most kMaxSplitSlots); with S > 1,
// `partial` holds B*Kh*S*G*(D+2) floats. (D, G = H / Kh) must be an instance:
// (64, 5), (32, 2) or (128, 8). Returns 0 once launched, else a cudaError_t.
extern "C" int ring_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* valid, void* out, void* partial, int B, int H,
                                  int Kh, int D, int length, int splits, int f32, float scale,
                                  void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || length <= 0 || splits <= 0 || splits > length ||
      (length + splits - 1) / splits > kMaxSplitSlots || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Kh;
  decltype(&launch<64, 5>) fn = D == 64 && G == 5    ? launch<64, 5>
                                : D == 32 && G == 2  ? launch<32, 2>
                                : D == 128 && G == 8 ? launch<128, 8>
                                                     : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(f32 != 0, q, k, v, valid, out, partial, B, Kh, length, splits, scale,
            static_cast<cudaStream_t>(stream));
}
