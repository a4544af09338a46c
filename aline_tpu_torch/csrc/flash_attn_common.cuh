// Device helpers shared by the role-masked flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu).
//
// A query row (or, in the backward's dK/dV pass, a key column) is owned by
// a group of G = dh/16 lanes (G = 1 for dh <= 16); each lane keeps
// DPT = dh/G of its dims in registers.  Every kernel computes a score with
// masked_score below, so the backward's passes recompute the forward's
// scores bit for bit: the same FMA order within a lane and the same
// xor-shuffle tree across the group.

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr int kThreads = 128;
constexpr int kTile = 64;        // keys (or rows) per shared-memory tile
constexpr float kNeg = -1e9f;    // the replaced score of a masked pair

template <int DH>
struct Split {
  static constexpr int DPT = DH < 16 ? DH : 16;  // dims per lane
  static constexpr int G = DH / DPT;             // lanes per row or column
  static constexpr int ROWS = kThreads / G;      // rows or columns per CTA
};

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int N4>
__device__ __forceinline__ void load_dims(float* dst, const float* src,
                                          bool live) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int d4 = 0; d4 < N4; ++d4) {
    const float4 x = live ? s[d4] : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * d4 + 0] = x.x;
    dst[4 * d4 + 1] = x.y;
    dst[4 * d4 + 2] = x.z;
    dst[4 * d4 + 3] = x.w;
  }
}

template <int N4>
__device__ __forceinline__ void store_dims(float* dst, const float* src,
                                           float mul) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int d4 = 0; d4 < N4; ++d4)
    d[d4] = make_float4(src[4 * d4 + 0] * mul, src[4 * d4 + 1] * mul,
                        src[4 * d4 + 2] * mul, src[4 * d4 + 3] * mul);
}

// sum over the lane's dims of a[d] * row[d], in one fixed order
template <int N4>
__device__ __forceinline__ float dot_dims(const float* a, const float4* row) {
  float dot = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < N4; ++d4) {
    const float4 w = row[d4];
    dot = fmaf(a[4 * d4 + 0], w.x, dot);
    dot = fmaf(a[4 * d4 + 1], w.y, dot);
    dot = fmaf(a[4 * d4 + 2], w.z, dot);
    dot = fmaf(a[4 * d4 + 3], w.w, dot);
  }
  return dot;
}

// acc[d] += p * row[d] over the lane's dims
template <int N4>
__device__ __forceinline__ void axpy_dims(float* acc, float p,
                                          const float4* row) {
#pragma unroll
  for (int d4 = 0; d4 < N4; ++d4) {
    const float4 w = row[d4];
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
template <int DH>
__device__ __forceinline__ float masked_score(const float* a, const float4* b,
                                              float scale, int kc,
                                              bool is_query) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  const float s = group_sum<G>(dot_dims<DPT / 4>(a, b)) * scale;
  return (kc == 1 || (is_query && kc == 2)) ? s : kNeg;
}

}  // namespace flash
