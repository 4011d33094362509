// Paged decode attention for Hopper (sm_90a), one query token per sequence.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_kernel, body _kernel). Same function: GQA with
// G = H / Kh query heads per KV head, f32 online softmax scaled by D^-0.5,
// the planner's block descriptors walked in order, token mask
// `tok < nvalid*T && cnt*T + tok < length` (cnt: valid pages of earlier
// descriptors), descriptors with nvalid = 0 leave the carry untouched,
// output acc / max(l, 1e-30).
//
// Layouts (all contiguous):
//   q           (B, H, D)            f32 or bf16
//   kv          (P, T, 2, Kh, D)     same dtype; K and V interleaved on axis 2
//   block_start (B, NB) int32        first page of each descriptor (a run of pages)
//   block_valid (B, NB) int32        pages in the descriptor, 0 = empty
//   lengths     (B,)    int32        tokens in the sequence
//   out         (B, H, D)            q's dtype
//   partial     (B*Kh, S, G, D + 2)  f32 scratch, only when S > 1
//
// Bound on this card: bytes. Decode reads each cached K/V row once per step
// and does 4*D flops on it per query head, about G flops a byte, far below
// the ~295 at which an H100 turns compute-bound. So there are no tensor
// cores here; the design is about streaming the pool from device memory.
//
// Design.
// - Split-KV (flash-decoding). The grid is (B*Kh/HG, S): a CTA covers HG
//   neighbouring KV heads (1, 2 or 4) of one sequence and takes split s of
//   its descriptors, [s*per, (s+1)*per) with per = ceil(live / S), the last
//   split running on to NB. `live` is the host's count of descriptors that
//   hold live tokens; only the balance depends on it, never the result. The
//   host (ops.py launch_shape) keeps S = 1 for a short context and splits a
//   long one so that every SM gets two CTAs. With S = 1 the CTA writes the
//   output; with S > 1 it writes a partial (m, l, acc) per head and a
//   second launch merges the S partials.
// - One bulk copy per run, into a ring. A TMA tensor map over one layer's
//   pool, dims (D, Kh, 2, P*T) innermost first, box (D, HG, 2, C): one
//   instruction fetches the K and V rows of HG heads for C tokens of a
//   run. The host sizes a stage at 16 KB: C is the whole R-page run when
//   it fits (R = 4, T = 16, bf16 D = 64: exactly), else the run cut into
//   the fewest equal pieces that fit; a run smaller than a stage (R = 1, a
//   fragmented table) is widened across HG heads instead, so every copy
//   stays a stage long. Copies land in a ring of kStages = 2 stages and
//   complete on an mbarrier each; thread 0 walks the descriptors and keeps
//   the next copy in flight while the current stage is consumed, and a
//   stage is waited on only then: the counterpart of the TPU kernel's
//   make_async_copy(kv_hbm.at[pl.ds(start, R)]) into a 2-slot buffer. A box
//   may run past a run's live tokens (slack or foreign pages): those tokens
//   are never read. The walk stops as soon as the sequence's length is
//   reached, so neither the pages nor the empty plan columns past it are
//   touched.
// - What bounds it (PERF.md, tools/kernel_variants.py): at 8192 tokens of
//   context the copy alone takes ~95 % of the kernel's time; larger copies
//   stream faster (the same plan with 64-, 32- and 16-token stages), and
//   deeper rings measured slower.
// - Every lane busy for any G. Warp w serves head w % HG and a 1/(4/HG)
//   slice of each stage's tokens. Lanes split a row into 16-byte vectors:
//   L = D*sizeof(T)/16 lanes a row, so one warp instruction covers 32/L
//   tokens. The G query rows sit in f32 registers; a score is reduced by
//   shuffles over a row's L lanes. Each group of L lanes keeps its own
//   online softmax (m, l, acc in registers), updated once per batch of
//   kBatch tokens; groups merge by shuffles, a head's warps through shared
//   memory, once, at the end. Masks are applied by select: a masked
//   token's K and V are never loaded.
// - The host side never synchronises: the tensor map is encoded once per
//   (pool pointer, shape, dtype, HG, box) and cached, and
//   cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint, so the
//   library links no libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;             // ring depth: one copy in flight while one is read
constexpr int kMaxBoxTokens = 256;     // TMA's limit on a box extent
constexpr int kBatch = 4;              // tokens a lane group scores per softmax update
constexpr float kNegInf = -1e30f;      // finite: exp2(kNegInf - kNegInf) is 1, not NaN
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of the 4-d map (D, Kh, 2, tokens) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int kh, int tok) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(kh), "r"(0), "r"(tok),
      "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes of T as f32: 8 bf16 or 4 f32.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&x)[N]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // bf16 -> f32 is a shift into the high half
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&x)[N]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Merge the online-softmax state (m, l, acc) with another one (log2 domain).
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&acc)[N], float m_o,
                                            float l_o, const float (&acc_o)[N]) {
  const float m_n = fmaxf(m, m_o);
  const float a = exp2f(m - m_n), c = exp2f(m_o - m_n);
  l = l * a + l_o * c;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * a + acc_o[e] * c;
  m = m_n;
}

// Thread 0's walk over one split's descriptors [i, last): each next() is one
// stage, up to C live tokens of one run starting at pool token `tok`, or 0
// once the split is done (past its last descriptor or the sequence's length).
struct Walk {
  const int* valid;   // the sequence's block_valid row
  const int* start;   // its block_start row
  int i, last, c0, cnt, len, page_tokens, C;

  __device__ __forceinline__ int next(int& tok) {
    while (i < last) {
      // past the length nothing later is live: stop here, not after scanning
      // the plan's trailing empty columns one dependent load at a time
      if (cnt * page_tokens >= len) break;
      const int nvalid = valid[i];
      const int ntok = min(nvalid * page_tokens, len - cnt * page_tokens);
      if (c0 < ntok) {
        tok = start[i] * page_tokens + c0;
        const int n = min(C, ntok - c0);
        c0 += C;
        return n;
      }
      cnt += nvalid;
      ++i;
      c0 = 0;
    }
    i = last;
    return 0;
  }
};

// The next stage of `walk` into ring slot `slot`: one TMA box completing on
// full[slot], or a plain arrival with 0 tokens once the walk is done.
template <typename T>
__device__ __forceinline__ void produce(Walk& walk, int slot, int* stage_tokens, uint64_t* full,
                                        T* dst, const CUtensorMap* map, int kh0,
                                        uint32_t bytes) {
  int tok = 0;
  const int n = walk.next(tok);
  stage_tokens[slot] = n;
  if (n > 0) {
    mbar_arrive_expect_tx(&full[slot], bytes);
    tma_load(dst, map, &full[slot], kh0, tok);
  } else {
    mbar_arrive(&full[slot]);
  }
}

// GP: G rounded up to a power of two (the register arrays' extent).
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ q,
                       const int* __restrict__ block_start, const int* __restrict__ block_valid,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       float* __restrict__ partial, int H, int Kh, int heads, int page_tokens,
                       int NB, int box_tokens, int per_split, float scale_log2) {
  constexpr int V = Vec<T>::N;        // elements in a lane's 16-byte vector
  constexpr int L = D / V;            // lanes per K/V row
  constexpr int RW = 32 / L;          // rows one warp instruction covers
  static_assert(D % V == 0 && L >= 1 && L <= 32, "head dim");

  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int stage_tokens[kStages];
  const int C = box_tokens, stage_elems = C * 2 * heads * D;
  T* ring = reinterpret_cast<T*>(smem);
  float* merge = reinterpret_cast<float*>(smem + kStages * stage_elems * sizeof(T));

  const int groups = Kh / heads;                  // CTAs a sequence per split
  const int b = blockIdx.x / groups, kh0 = (blockIdx.x % groups) * heads;
  const int split = blockIdx.y, S = gridDim.y;
  const int G = H / Kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / L, sub = lane % L;
  // warp -> (its KV head, its slice of each stage's tokens)
  const int slices = kWarps / heads, hj = warp % heads, slice = warp / heads;
  const int kh = kh0 + hj;
  const int first = min(NB, split * per_split);
  const int last = split == S - 1 ? NB : min(NB, first + per_split);
  const int len = lengths[b];
  const int* valid_b = block_valid + (long)b * NB;
  const int* start_b = block_start + (long)b * NB;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // cnt at this split's first descriptor: the valid pages before it
  int cnt = 0;
  if (warp == 0) {
    for (int j = lane; j < first; j += 32) cnt += valid_b[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  }
  __syncthreads();

  Walk walk{valid_b, start_b, first, last, 0, cnt, len, page_tokens, C};   // thread 0's

  // the lane's slice of the G query rows, as f32
  float qr[GP][V];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      Vec<T>::load(q + ((long)b * H + kh * G + g) * D + sub * V, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) qr[g][e] = 0.f;
    }
  }
  float m[GP], l[GP], acc[GP][V];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }

  const uint32_t stage_bytes = stage_elems * sizeof(T);
  if (tid == 0)
    for (int k = 0; k < kStages - 1; ++k)
      produce(walk, k, stage_tokens, full, ring + k * stage_elems, &map, kh0, stage_bytes);
  for (int k = 0;; ++k) {
    if (tid == 0) {                           // into the slot freed last iteration
      const int next = (k + kStages - 1) % kStages;
      produce(walk, next, stage_tokens, full, ring + next * stage_elems, &map, kh0, stage_bytes);
    }
    const int slot = k % kStages;
    mbar_wait(&full[slot], (k / kStages) & 1);
    const int n = stage_tokens[slot];
    if (n == 0) break;
    const T* stage = ring + slot * stage_elems + hj * D;   // token t: K at t*row, V + heads*D
    const int row = 2 * heads * D;
    // warp-uniform loop: every lane takes part in the shuffles
    for (int base = slice * RW; base < n; base += kBatch * slices * RW) {
      float s[kBatch][GP];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int t = base + grp + j * slices * RW;
        float kx[V];
        if (t < n) {
          Vec<T>::load(stage + t * row + sub * V, kx);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) kx[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) a = fmaf(qr[g][e], kx[e], a);
          s[j][g] = a;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int o = L / 2; o > 0; o >>= 1)
            s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], o);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const bool live = base + grp + j * slices * RW < n;
          s[j][g] = live ? s[j][g] * scale_log2 : kNegInf;
          m_new = fmaxf(m_new, s[j][g]);
        }
        const float corr = exp2f(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const bool live = base + grp + j * slices * RW < n;
          s[j][g] = live ? exp2f(s[j][g] - m_new) : 0.f;
          psum += s[j][g];
        }
        l[g] = l[g] * corr + psum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int t = base + grp + j * slices * RW;
        if (t < n) {
          float vx[V];
          Vec<T>::load(stage + t * row + heads * D + sub * V, vx);
#pragma unroll
          for (int g = 0; g < GP; ++g)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[g][e] = fmaf(s[j][g], vx[e], acc[g][e]);
        }
      }
    }
    __syncthreads();   // every warp is done with the slot before it is refilled
  }

  // merge the warp's lane groups, then the warps through shared memory
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float acc_o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc_o[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      merge_state(m[g], l[g], acc[g], m_o, l_o, acc_o);
    }
  }
  constexpr int kRow = D + 2;          // acc[D], m, l
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g < G) {
        float* row = merge + (warp * GP + g) * kRow;
#pragma unroll
        for (int e = 0; e < V; ++e) row[sub * V + e] = acc[g][e];
        if (sub == 0) { row[D] = m[g]; row[D + 1] = l[g]; }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < heads * G * D; idx += kThreads) {
    const int h = idx / (G * D), g = idx / D % G, d = idx % D;   // h: head kh0 + h
    float mm = kNegInf;
    for (int w = h; w < kWarps; w += heads) mm = fmaxf(mm, merge[(w * GP + g) * kRow + D]);
    float ll = 0.f, aa = 0.f;
    for (int w = h; w < kWarps; w += heads) {
      const float* row = merge + (w * GP + g) * kRow;
      const float c = exp2f(row[D] - mm);
      ll += row[D + 1] * c;
      aa += row[d] * c;
    }
    if (S == 1) {
      out[((long)b * H + (kh0 + h) * G + g) * D + d] = from_float<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      float* row = partial + ((((long)b * Kh + kh0 + h) * S + split) * G + g) * kRow;
      row[d] = aa;
      if (d == 0) { row[D] = mm; row[D + 1] = ll; }
    }
  }
}

// Merge the S partials of each (sequence, KV head): one CTA each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine(const float* __restrict__ partial, T* __restrict__ out, int H, int Kh,
                        int D, int S) {
  const int bk = blockIdx.x, b = bk / Kh, kh = bk % Kh, G = H / Kh, row = D + 2;
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
    out[((long)b * H + kh * G + g) * D + d] = from_float<T>(aa / fmaxf(ll, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrEntryPoint = 20000;  // + cudaError_t of the entry-point lookup
constexpr int kErrEncode = 10000;      // + CUresult of cuTensorMapEncodeTiled

struct MapKey {
  const void* kv;
  long tokens;
  int Kh, D, bf16, heads, box;
  bool operator==(const MapKey& o) const {
    return kv == o.kv && tokens == o.tokens && Kh == o.Kh && D == o.D && bf16 == o.bf16 &&
           heads == o.heads && box == o.box;
  }
};

std::mutex g_mutex;
constexpr int kMapCache = 64;          // > the 24 pool layers of a serving model
MapKey g_keys[kMapCache];
CUtensorMap g_maps[kMapCache];
int g_used = 0, g_next = 0;
EncodeTiled g_encode = nullptr;

// The tensor map over one layer's pool; encoded once per key, then cached.
int tensor_map(const MapKey& key, CUtensorMap* map) {
  std::lock_guard<std::mutex> lock(g_mutex);
  for (int i = 0; i < g_used; ++i)
    if (g_keys[i] == key) { *map = g_maps[i]; return 0; }
  if (g_encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return kErrEntryPoint + static_cast<int>(err);
    g_encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t elem = key.bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(key.D), static_cast<cuuint64_t>(key.Kh),
                              2, static_cast<cuuint64_t>(key.tokens)};
  const cuuint64_t strides[3] = {key.D * elem, key.Kh * key.D * elem, 2 * key.Kh * key.D * elem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(key.D),
                             static_cast<cuuint32_t>(key.heads), 2,
                             static_cast<cuuint32_t>(key.box)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = g_encode(
      map, key.bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
      const_cast<void*>(key.kv), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return kErrEncode + static_cast<int>(rc);
  const int i = g_used < kMapCache ? g_used++ : (g_next++ % kMapCache);
  g_keys[i] = key;
  g_maps[i] = *map;
  return 0;
}

template <typename T, int D, int GP>
int launch(const CUtensorMap& map, const void* q, const void* bs, const void* bv,
           const void* len, void* out, void* partial, int B, int H, int Kh, int heads, int T_,
           int NB, int box, int live, int S, cudaStream_t stream) {
  const int smem = kStages * box * 2 * heads * D * static_cast<int>(sizeof(T)) +
                   kWarps * GP * (D + 2) * static_cast<int>(sizeof(float));
  static int smem_set = 0;             // the largest size allowed so far
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (smem > smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          paged_attention_kernel<T, D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = smem;
    }
  }
  const int per = (live + S - 1) / S;
  paged_attention_kernel<T, D, GP><<<dim3(B * Kh / heads, S), kThreads, smem, stream>>>(
      map, static_cast<const T*>(q), static_cast<const int*>(bs), static_cast<const int*>(bv),
      static_cast<const int*>(len), static_cast<T*>(out), static_cast<float*>(partial), H, Kh,
      heads, T_, NB, box, per, kLog2e / sqrtf(static_cast<float>(D)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  paged_attention_combine<T><<<B * Kh, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), H, Kh, D, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(const CUtensorMap& map, const void* q, const void* bs, const void* bv,
               const void* len, void* out, void* part, int B, int H, int Kh, int heads, int T_,
               int NB, int box, int live, int S, cudaStream_t s) {
  const int G = H / Kh;
  if (G <= 1) return launch<T, D, 1>(map, q, bs, bv, len, out, part, B, H, Kh, heads, T_, NB, box, live, S, s);
  if (G <= 2) return launch<T, D, 2>(map, q, bs, bv, len, out, part, B, H, Kh, heads, T_, NB, box, live, S, s);
  if (G <= 4) return launch<T, D, 4>(map, q, bs, bv, len, out, part, B, H, Kh, heads, T_, NB, box, live, S, s);
  return launch<T, D, 8>(map, q, bs, bv, len, out, part, B, H, Kh, heads, T_, NB, box, live, S, s);
}

template <typename T>
int dispatch_d(const CUtensorMap& map, const void* q, const void* bs, const void* bv,
               const void* len, void* out, void* part, int B, int H, int Kh, int heads, int D,
               int T_, int NB, int box, int live, int S, cudaStream_t s) {
  switch (D) {
    case 32: return dispatch_g<T, 32>(map, q, bs, bv, len, out, part, B, H, Kh, heads, T_, NB, box, live, S, s);
    case 64: return dispatch_g<T, 64>(map, q, bs, bv, len, out, part, B, H, Kh, heads, T_, NB, box, live, S, s);
    case 128: return dispatch_g<T, 128>(map, q, bs, bv, len, out, part, B, H, Kh, heads, T_, NB, box, live, S, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kv: one layer's pool of `pool_pages` pages. live: the most descriptors
// any sequence needs (an upper bound only sets the balance of the splits).
// heads: KV heads a CTA covers (1, 2 or 4, dividing Kh). box: tokens a
// stage holds (ops.py box_tokens). splits: S; with S > 1, `partial` holds
// B*Kh*S*G*(D+2) floats.
// Returns 0 once launched, else a cudaError_t (or kErrEncode/kErrEntryPoint + code).
extern "C" int paged_attention_fwd(const void* q, const void* kv, const void* block_start,
                                   const void* block_valid, const void* lengths, void* out,
                                   void* partial, int B, int H, int Kh, int D, int page_tokens,
                                   int pool_pages, int NB, int box, int live, int heads,
                                   int splits, int is_bf16, void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || H / Kh > 8 || NB <= 0 || page_tokens <= 0 ||
      box <= 0 || box > kMaxBoxTokens || splits <= 0 || (splits > 1 && partial == nullptr) ||
      (heads != 1 && heads != 2 && heads != 4) || Kh % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MapKey key{kv, static_cast<long>(pool_pages) * page_tokens, Kh, D, is_bf16, heads, box};
  CUtensorMap map;
  const int rc = tensor_map(key, &map);
  if (rc != 0) return rc;
  live = live < 1 ? 1 : (live > NB ? NB : live);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(map, q, block_start, block_valid, lengths, out,
                                             partial, B, H, Kh, heads, D, page_tokens, NB, box,
                                             live, splits, s)
                 : dispatch_d<float>(map, q, block_start, block_valid, lengths, out, partial, B,
                                     H, Kh, heads, D, page_tokens, NB, box, live, splits, s);
}
