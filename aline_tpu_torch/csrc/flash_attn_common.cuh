// Device helpers shared by the role-masked flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu).
//
// The kernels walk a plan of the role mask (flash_plan.cu): per batch row,
// key_perm lists the context keys (code 1), then the keys that only query
// rows see (code 2), then the invisible ones (code 0), and row_perm the
// query rows, then the others, each group in index order.  A key's code and
// a row's kind follow from their position in these lists, so no kernel
// reads kcode or qrow.
//
// A query row (or, in the backward's dK/dV pass, a key column) is owned by
// a group of G = dh/16 lanes (G = 1 for dh <= 16); each lane keeps
// DPT = dh/G of its dims in registers (the float32 kernels).
//
// The kernels take dh in {8, 16, 32, 64, 128}; the wrapper zero-pads any
// other dh up to 128 to the next of these (exact: a zero dim adds 0 to
// every dot product, and the scale is the true dh's).  The shared-memory
// rings are dynamic (dyn_smem, allow_smem): at dh = 128 they outgrow the
// 48 KB that static shared memory may hold.  Every float32
// kernel computes a score with masked_score below, so the backward's
// passes recompute the forward's scores bit for bit: the same FMA order
// within a lane and the same xor-shuffle tree across the group.
//
// The float32 kernels read and write their arrays (T = float) through the
// helpers below.  The bfloat16 kernels have building blocks of their own
// (flash_attn_mma.cuh) and take from here the plan and, for the backward's
// D, the widening reads (a bfloat16 element widened to float32 is exact).
// lse and D are float32 in both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kThreads = 128;
constexpr float kNeg = -1e9f;    // the replaced score of a masked pair

template <int DH>
struct Split {
  static constexpr int DPT = DH < 16 ? DH : 16;  // dims per lane
  static constexpr int G = DH / DPT;             // lanes per row or column
  static constexpr int ROWS = kThreads / G;      // rows or columns per CTA
  // keys (or rows) per shared-memory stage: two stages of two [TILE, DH]
  // float arrays take 32 KB up to dh = 64 and 64 KB at dh = 128
  static constexpr int TILE = DH <= 32 ? 64 : 32;
};

using bf16 = __nv_bfloat16;

// The plan of one batch's mask, as flash_plan.cu writes it (device pointers).
struct Plan {
  const int* key_perm;   // [B, N]
  const int* row_perm;   // [B, N]
  const int* n_ctx;      // [B] keys of code 1
  const int* n_vis;      // [B] keys of code 1 or 2
  const int* n_query;    // [B] query rows
  const int* dense;      // [B] 1 where some row sees no key
};

// One batch row's plan.  The walk lengths are non-increasing in the
// position, so a block of positions walks as far as its first one.
struct PlanRow {
  const int* key_perm;
  const int* row_perm;
  int n_ctx, n_vis, n_query, N;
  bool dense;

  // the code of the key at position p of key_perm
  __device__ __forceinline__ int code(int p) const {
    return p < n_ctx ? 1 : (p < n_vis ? 2 : 0);
  }
  // how many keys of key_perm the row at position r of row_perm walks
  __device__ __forceinline__ int keys_for(int r) const {
    if (r >= N) return 0;
    return dense ? N : (r < n_query ? n_vis : n_ctx);
  }
  // whether the role codes let the row at position r of row_perm see the
  // key at position p of key_perm
  __device__ __forceinline__ bool allows(int r, int p) const {
    return p < n_ctx || (r < n_query && p < n_vis);
  }
  // how many rows of row_perm the key at position p of key_perm walks: a
  // context key all rows, a code-2 key the query rows, a code-0 key none
  __device__ __forceinline__ int rows_for(int p) const {
    if (p >= N) return 0;
    return dense ? N : (p < n_ctx ? N : (p < n_vis ? n_query : 0));
  }
};

__device__ __forceinline__ PlanRow plan_row(const Plan& plan, int b, int N) {
  PlanRow r;
  r.key_perm = plan.key_perm + (size_t)b * N;
  r.row_perm = plan.row_perm + (size_t)b * N;
  r.n_ctx = plan.n_ctx[b];
  r.n_vis = plan.n_vis[b];
  r.n_query = plan.n_query[b];
  r.N = N;
  r.dense = plan.dense[b] != 0;
  return r;
}

// -- dynamic shared memory ----------------------------------------------------

// The block's dynamic shared memory (16-byte aligned) as T
template <typename T>
__device__ __forceinline__ T* dyn_smem() {
  extern __shared__ float4 flash_smem[];
  return reinterpret_cast<T*>(flash_smem);
}

// Stage i of a ring of equal tiles in shared memory: base + i * stride
// (arithmetic, so a run-time stage index costs no local memory)
template <typename T>
struct Ring {
  T* base;
  int stride;
  __device__ __forceinline__ T* operator[](int i) const {
    return base + i * stride;
  }
};

constexpr int kMaxDevices = 64;

// Let kernel fn take smem bytes of dynamic shared memory on the current
// device; granted[dev] remembers the most it was given there (one array
// per kernel, kept by the caller).
inline cudaError_t allow_smem(const void* fn, size_t smem, int* granted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if ((int)smem <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) granted[dev] = (int)smem;
  return e;
}

// -- asynchronous copies into shared memory (sm_80+) ------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Gather rows perm[p0 .. p0+n) of the [N, DH] arrays a and b (one (b, h)
// head) into shared memory as [n, DH] each, by 16-byte cp.async copies: a
// row is DH/4 copies in float32, DH/8 in bfloat16 (one at DH = 8).
template <int DH, typename T>
__device__ __forceinline__ void gather_rows(T* sa, T* sb, const T* a,
                                            const T* b, const int* perm,
                                            int p0, int n) {
  constexpr int E = 16 / sizeof(T);   // elements a copy
  constexpr int V = DH / E;           // copies a row
  for (int t = threadIdx.x; t < n * V; t += kThreads) {
    const int s = t / V, c = t - s * V;
    const size_t src = (size_t)perm[p0 + s] * DH + E * c;
    cp_async16(sa + s * DH + E * c, a + src);
    cp_async16(sb + s * DH + E * c, b + src);
  }
}

// -- reading and writing a lane's dims ---------------------------------------

// the 8 bfloat16 of a 16-byte word, widened
__device__ __forceinline__ void widen8(float* dst, const uint4& w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    dst[2 * e + 0] = f.x;
    dst[2 * e + 1] = f.y;
  }
}

// x rounded to T and widened back: the identity for float
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return x;
}

template <>
__device__ __forceinline__ float rounded<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// DPT bfloat16 at src (16-byte aligned, shared or global) as floats
template <int DPT>
__device__ __forceinline__ void widen_dims(float* dst, const bf16* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < DPT / 8; ++c) widen8(dst + 8 * c, s[c]);
}

// -- the score routine --------------------------------------------------------

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a lane's DPT dims from global memory (zeros where the row is not live)
template <int DPT>
__device__ __forceinline__ void load_dims(float* dst, const float* src,
                                          bool live) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int d4 = 0; d4 < DPT / 4; ++d4) {
    const float4 x = live ? s[d4] : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * d4 + 0] = x.x;
    dst[4 * d4 + 1] = x.y;
    dst[4 * d4 + 2] = x.z;
    dst[4 * d4 + 3] = x.w;
  }
}

template <int DPT>
__device__ __forceinline__ void load_dims(float* dst, const bf16* src,
                                          bool live) {
  if (live) {
    widen_dims<DPT>(dst, src);
  } else {
#pragma unroll
    for (int d = 0; d < DPT; ++d) dst[d] = 0.f;
  }
}

// dst[d] = src[d] * mul over a lane's DPT dims, in global memory
template <int DPT>
__device__ __forceinline__ void store_dims(float* dst, const float* src,
                                           float mul) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int d4 = 0; d4 < DPT / 4; ++d4)
    d[d4] = make_float4(src[4 * d4 + 0] * mul, src[4 * d4 + 1] * mul,
                        src[4 * d4 + 2] * mul, src[4 * d4 + 3] * mul);
}

// sum over the lane's dims of a[d] * row[d], in one fixed order; row is in
// shared memory
template <int DPT>
__device__ __forceinline__ float dot_dims(const float* a, const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float dot = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < DPT / 4; ++d4) {
    const float4 w = r[d4];
    dot = fmaf(a[4 * d4 + 0], w.x, dot);
    dot = fmaf(a[4 * d4 + 1], w.y, dot);
    dot = fmaf(a[4 * d4 + 2], w.z, dot);
    dot = fmaf(a[4 * d4 + 3], w.w, dot);
  }
  return dot;
}

// acc[d] += p * row[d] over the lane's dims; row is in shared memory
template <int DPT>
__device__ __forceinline__ void axpy_dims(float* acc, float p,
                                          const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int d4 = 0; d4 < DPT / 4; ++d4) {
    const float4 w = r[d4];
    acc[4 * d4 + 0] = fmaf(p, w.x, acc[4 * d4 + 0]);
    acc[4 * d4 + 1] = fmaf(p, w.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(p, w.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(p, w.w, acc[4 * d4 + 3]);
  }
}

// The score of (row, key): (a . b) * scale from the group's lanes, replaced
// by -1e9 where the role codes mask the pair.  kc is the key's code, and
// is_query whether the row is a query row.  Every lane of the warp must
// call it together (it shuffles).
template <int DH, typename T>
__device__ __forceinline__ float masked_score(const float* a, const T* b,
                                              float scale, int kc,
                                              bool is_query) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  const float s = group_sum<G>(dot_dims<DPT>(a, b)) * scale;
  return (kc == 1 || (is_query && kc == 2)) ? s : kNeg;
}

}  // namespace flash
