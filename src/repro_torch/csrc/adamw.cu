// AdamW over every leaf of a model in two launches, for Hopper (sm_90a): one
// pass for the gradients' global L2 norm, then one fused pass that clips,
// updates both moments, decays and writes each parameter back in its dtype.
//
// Replaces no TPU kernel. The reference leaves its optimizer to XLA, which
// fuses the elementwise update of each leaf (src/repro/optim/adamw.py update
// and clip_by_global_norm). The port's plain version
// (kernels/adamw/ref.py adamw_plain, clip_by_global_norm_plain) runs the same
// arithmetic one PyTorch operation at a time, leaf by leaf: about 25 launches
// a leaf and some 190 bytes of device traffic an element. At hymba-1.5b's 611
// leaves (1,641,278,720 elements) that was ~15,500 launches a step.
//
// Function, for the leaves l and their elements i, in f32:
//   gn        = sqrt(sum_l sum_i g[l][i]^2)
//   scale     = min(1, max_norm / max(gn, 1e-12))
//   g         = g_in * scale
//   m'        = b1 * m + c1 * g                  (c1 = 1 - b1)
//   v'        = b2 * v + c2 * g * g              (c2 = 1 - b2)
//   upd       = (m' * inv_bc1) / (sqrt(v' * inv_bc2) + eps)  (+ wd * p on decayed leaves)
//   p         = round_to_nearest_even(p - lr * upd) in p's dtype, in place
// m' and v' go to new tensors; m and v are only read. Every
// step of that formula is one f32 rounding, in the order the plain version's
// PyTorch operations round on the card (explicit _rn intrinsics, so no
// multiply-add is contracted): with the same scale, the two agree in every
// bit. The norm sums in another order than the plain version's, and in f64:
// its squares are summed in f32 eight at a time (exact for bf16 gradients),
// those sums in f64 a thread, the threads and the blocks in f64 too.
//
// Bound on this card: bytes. The least traffic is 24 bytes an element for
// bf16 gradients and parameters: the norm pass reads g (2); the update reads
// g, p, m, v (2 + 2 + 4 + 4) and writes p, m', v' (2 + 4 + 4). At hymba-1.5b
// that is 39.4 GB, 11.76 ms at 3.35 TB/s, against some 20 flops an element.
//
// Design.
// - A leaf table built by the wrapper: meta (L, 3) int64 = the leaf's
//   element count, its first chunk and its flags (decay, f32 gradient, f32
//   parameter), which depend only on the leaves' sizes and dtypes and stay on
//   the device; ptrs (L, 6) int64 = the addresses of g, p, m, v, m' and v',
//   copied up each step from pinned memory in one asynchronous copy.
//   chunk_leaf (C,) int32 maps each chunk of kChunk elements to its leaf; a
//   leaf's chunks start at multiples of kChunk inside it, so a leaf's last
//   chunk may be short.
// - Both kernels walk the chunks grid-stride, a block a chunk at a time, a
//   thread eight elements at a time with 16-byte loads and stores (g, m and
//   v through the read-only path). A leaf with
//   any address off 16 bytes, and the tail of a leaf past its last multiple
//   of eight, take one element a thread.
// - The norm kernel writes one f64 partial a block. The update kernel's
//   blocks each sum all partials in one fixed order, so every block, and
//   every run, gets the same norm bit for bit; block 0 writes gn. No atomics,
//   no host sync: the scale never leaves the device.
// - The grids depend on the chunk count and the SM count only, never on the
//   values, so the reduction order is fixed for a given set of leaf sizes.
// - The host side never synchronises and the kernels allocate nothing: the
//   wrapper allocates the tables, the partials, m', v' and gn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                                  // elements a thread takes at a time
constexpr int64_t kChunk = int64_t(kThreads) * kVec * 16;  // 32768 elements a chunk
constexpr int64_t kDecay = 1, kGradF32 = 2, kParamF32 = 4;  // meta's flags
constexpr int kMeta = 3, kPtrs = 6;                      // columns of meta and of ptrs

struct Scalars {
  float max_norm, b1, c1, b2, c2, inv_bc1, inv_bc2, eps, wd, lr;
};

// ---- loads and stores of eight elements --------------------------------------

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  return u;
}

// read-only loads (g, m, v: never written by the kernel)
__device__ __forceinline__ void load_ro(const __nv_bfloat16* p, float (&x)[kVec]) {
  unpack(__ldg(reinterpret_cast<const uint4*>(p)), x);
}

__device__ __forceinline__ void load_ro(const float* p, float (&x)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// the parameter: read, then written in place
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[kVec]) {
  unpack(*reinterpret_cast<const uint4*>(p), x);
}

__device__ __forceinline__ void load(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[kVec]) {
  *reinterpret_cast<uint4*>(p) = pack(x);
}

__device__ __forceinline__ void store(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The sum over the block in f64, in one fixed order; valid in thread 0.
__device__ __forceinline__ double block_sum(double x, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// A chunk: its leaf's flags and row of ptrs, and its range [start, end) in the leaf.
struct Chunk {
  int64_t start, end, flags;
  const int64_t* ptrs;
};

__device__ __forceinline__ Chunk chunk_at(const int64_t* meta, const int64_t* ptrs,
                                          const int32_t* chunk_leaf, int c) {
  const int leaf = chunk_leaf[c];
  const int64_t* me = meta + kMeta * int64_t(leaf);
  const int64_t start = (int64_t(c) - me[1]) * kChunk;
  const int64_t end = start + kChunk < me[0] ? start + kChunk : me[0];
  return {start, end, me[2], ptrs + kPtrs * int64_t(leaf)};
}

// ---- the norm --------------------------------------------------------------------

template <typename G>
__device__ __forceinline__ double sum_squares(const G* g, int64_t start, int64_t end) {
  const int64_t vend = aligned16(g) ? start + (end - start) / kVec * kVec : start;
  double acc = 0.0;
  for (int64_t i = start + int64_t(threadIdx.x) * kVec; i < vend; i += int64_t(kThreads) * kVec) {
    float x[kVec];
    load_ro(g + i, x);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) s = fmaf(x[k], x[k], s);
    acc += double(s);
  }
  for (int64_t i = vend + threadIdx.x; i < end; i += kThreads) {
    const float x = to_f32(g[i]);
    acc += double(x * x);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) adamw_norm_kernel(
    const int64_t* __restrict__ meta, const int64_t* __restrict__ ptrs,
    const int32_t* __restrict__ chunk_leaf, int n_chunks, double* __restrict__ partials) {
  __shared__ double red[kWarps];
  double acc = 0.0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = chunk_at(meta, ptrs, chunk_leaf, c);
    const void* g = reinterpret_cast<const void*>(ch.ptrs[0]);
    acc += (ch.flags & kGradF32)
               ? sum_squares(static_cast<const float*>(g), ch.start, ch.end)
               : sum_squares(static_cast<const __nv_bfloat16*>(g), ch.start, ch.end);
  }
  const double t = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = t;
}

// ---- the update --------------------------------------------------------------------

// One element: g_in the gradient as stored (widened), p the parameter in f32
// (updated in place), m and v the moments (replaced by m' and v').
__device__ __forceinline__ void adamw_one(float g_in, float& p, float& m, float& v, float scale,
                                          bool decay, const Scalars& s) {
  const float g = __fmul_rn(g_in, scale);
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.c1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.c2, __fmul_rn(g, g)));
  float upd = __fdiv_rn(__fmul_rn(m, s.inv_bc1),
                        __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps));
  if (decay) upd = __fadd_rn(upd, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

template <typename G, typename P>
__device__ __forceinline__ void update_range(const Chunk& ch, float scale, const Scalars& s) {
  const G* g = reinterpret_cast<const G*>(ch.ptrs[0]);
  P* p = reinterpret_cast<P*>(ch.ptrs[1]);
  const float* m = reinterpret_cast<const float*>(ch.ptrs[2]);
  const float* v = reinterpret_cast<const float*>(ch.ptrs[3]);
  float* mo = reinterpret_cast<float*>(ch.ptrs[4]);
  float* vo = reinterpret_cast<float*>(ch.ptrs[5]);
  const bool decay = ch.flags & kDecay;
  const bool vec = aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v) &&
                   aligned16(mo) && aligned16(vo);
  const int64_t vend = vec ? ch.start + (ch.end - ch.start) / kVec * kVec : ch.start;
  for (int64_t i = ch.start + int64_t(threadIdx.x) * kVec; i < vend;
       i += int64_t(kThreads) * kVec) {
    float gx[kVec], px[kVec], mx[kVec], vx[kVec];
    load_ro(g + i, gx);
    load(p + i, px);
    load_ro(m + i, mx);
    load_ro(v + i, vx);
#pragma unroll
    for (int k = 0; k < kVec; ++k) adamw_one(gx[k], px[k], mx[k], vx[k], scale, decay, s);
    store(p + i, px);
    store(mo + i, mx);
    store(vo + i, vx);
  }
  for (int64_t i = vend + threadIdx.x; i < ch.end; i += kThreads) {
    float pe = to_f32(p[i]), me = m[i], ve = v[i];
    adamw_one(to_f32(g[i]), pe, me, ve, scale, decay, s);
    put(p + i, pe);
    mo[i] = me;
    vo[i] = ve;
  }
}

__global__ void __launch_bounds__(kThreads) adamw_update_kernel(
    const int64_t* __restrict__ meta, const int64_t* __restrict__ ptrs,
    const int32_t* __restrict__ chunk_leaf, int n_chunks, const double* __restrict__ partials,
    int n_partials, float* __restrict__ gn_out, Scalars s) {
  __shared__ double red[kWarps];
  __shared__ float scale_s;
  double t = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) t += partials[i];
  t = block_sum(t, red);
  if (threadIdx.x == 0) {
    const float gn = float(sqrt(t));
    // the plain version's clamp(max_norm / gn.clamp(min=1e-12), max=1):
    // reciprocal, then the product; a NaN norm stays NaN
    const float r = __fmul_rn(__frcp_rn(gn < 1e-12f ? 1e-12f : gn), s.max_norm);
    scale_s = r > 1.f ? 1.f : r;
    if (blockIdx.x == 0) *gn_out = gn;
  }
  __syncthreads();
  const float scale = scale_s;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = chunk_at(meta, ptrs, chunk_leaf, c);
    switch (ch.flags & (kGradF32 | kParamF32)) {
      case 0: update_range<__nv_bfloat16, __nv_bfloat16>(ch, scale, s); break;
      case kGradF32: update_range<float, __nv_bfloat16>(ch, scale, s); break;
      case kParamF32: update_range<__nv_bfloat16, float>(ch, scale, s); break;
      default: update_range<float, float>(ch, scale, s); break;
    }
  }
}

}  // namespace

// The whole step: the norm over every chunk (norm_blocks partials), then the
// update (update_blocks blocks), on ``stream``. Returns cudaGetLastError().
extern "C" int adamw_fused(const void* meta, const void* ptrs, const void* chunk_leaf,
                           int n_chunks, int norm_blocks, int update_blocks, void* partials,
                           void* gn_out, float max_norm, float b1, float c1, float b2, float c2,
                           float inv_bc1, float inv_bc2, float eps, float wd, float lr,
                           void* stream) {
  if (n_chunks <= 0 || norm_blocks <= 0 || update_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* me = static_cast<const int64_t*>(meta);
  const int64_t* pt = static_cast<const int64_t*>(ptrs);
  const int32_t* cl = static_cast<const int32_t*>(chunk_leaf);
  double* part = static_cast<double*>(partials);
  adamw_norm_kernel<<<norm_blocks, kThreads, 0, st>>>(me, pt, cl, n_chunks, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Scalars s{max_norm, b1, c1, b2, c2, inv_bc1, inv_bc2, eps, wd, lr};
  adamw_update_kernel<<<update_blocks, kThreads, 0, st>>>(me, pt, cl, n_chunks, part,
                                                          norm_blocks,
                                                          static_cast<float*>(gn_out), s);
  return static_cast<int>(cudaGetLastError());
}
