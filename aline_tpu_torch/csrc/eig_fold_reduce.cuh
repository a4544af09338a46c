// The task-independent half of the EIG fold kernels (loc_eig_fold.cu,
// ces_eig_fold.cu): the streaming logsumexp over a chunk's draws.
//
// A fold kernel's block takes one row b and kThreads * kDraws draws and
// walks the steps t with all its threads together, each thread holding
// its draws' running sums S_j in registers.  At each step
//  * a thread reduces its own sums to (m, s) = (max_j S_j, sum_j
//    exp(S_j - m)), in j order (``thread_pair``), into its slot of a
//    shared tile of steps;
//  * after each tile, one warp per step combines the block's kThreads
//    slots: lane i takes slots i, i + 32, ... in that order, then a
//    shuffle-down tree over 16, 8, 4, 2, 1; lane 0 writes the block's
//    partial (m, s) of the step (``tile_partials``);
//  * a second kernel, one thread per (b, t), combines the partials over
//    the blocks in order and merges the result into the incoming state,
//    as parallel/collectives.py lse_update does (``launch_merge``).
// Every sum runs in a fixed order and no float is added atomically, so a
// call's result is the same bits on every call.  tests/test_torch_eig_fold.py
// emulates this order on the CPU.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace eig_fold {

constexpr int kMergeThreads = 256;

// (max, sum of exp(v - max)) pairs combined as
// parallel/collectives.py streaming_logsumexp_combine: both sums rescaled
// to the larger max; an empty pair (max = -inf) adds 0.
__device__ __forceinline__ float2 combine(float2 a, float2 b) {
  const float m = fmaxf(a.x, b.x);
  const float safe = m == -INFINITY ? 0.0f : m;
  return make_float2(m, a.y * expf(a.x - safe) + b.y * expf(b.x - safe));
}

// A thread's (max, sumexp) over its first nj sums, in j order; (-inf, 0)
// when nj = 0 or every sum is -inf (an outcome the likelihood rules out)
template <int N>
__device__ __forceinline__ float2 thread_pair(const float (&S)[N], int nj) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < nj) m = fmaxf(m, S[j]);
  const float safe = m == -INFINITY ? 0.0f : m;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < nj) s += expf(S[j] - safe);
  return make_float2(m, s);
}

// The block's partial of each of the tile's nt steps, slots [nt][kThreads]
// in, out[i] the partial of the tile's step i; the block's threads all call
// it, between two __syncthreads
template <int kThreads>
__device__ __forceinline__ void tile_partials(const float2* slots, int nt,
                                              float2* out) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < nt; i += kThreads / 32) {
    const float2* row = slots + i * kThreads;
    float2 v = row[lane];
#pragma unroll
    for (int q = 1; q < kThreads / 32; ++q) v = combine(v, row[lane + 32 * q]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float2 o = make_float2(__shfl_down_sync(0xffffffffu, v.x, off),
                                   __shfl_down_sync(0xffffffffu, v.y, off));
      v = combine(v, o);
    }
    if (lane == 0) out[i] = v;
  }
}

// The partials [G, n] combined over g in order, then merged into the state
__global__ void __launch_bounds__(kMergeThreads)
    fold_merge(const float2* __restrict__ part, long long G, long long n,
               const float* __restrict__ max_in,
               const float* __restrict__ sumexp_in, float* __restrict__ max_out,
               float* __restrict__ sumexp_out) {
  const long long e = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= n) return;
  float2 c = make_float2(-INFINITY, 0.0f);
  for (long long g = 0; g < G; ++g) c = combine(c, part[g * n + e]);
  const float2 st = combine(make_float2(max_in[e], sumexp_in[e]), c);
  max_out[e] = st.x;
  sumexp_out[e] = st.y;
}

// Blocks a row of a chunk with n_valid valid draws, block_draws a block
inline long long n_groups(long long n_valid, int block_draws) {
  return n_valid > 0 ? (n_valid + block_draws - 1) / block_draws : 0;
}

// Steps of each shared tile: Th in tiles of equal size, at most tile_max
inline int tile_steps(int Th, int tile_max) {
  const int n_tiles = (Th + tile_max - 1) / tile_max;
  return (Th + n_tiles - 1) / n_tiles;
}

inline cudaError_t launch_merge(const float2* part, long long G, long long n,
                                const float* max_in, const float* sumexp_in,
                                float* max_out, float* sumexp_out,
                                cudaStream_t s) {
  fold_merge<<<(unsigned)((n + kMergeThreads - 1) / kMergeThreads),
               kMergeThreads, 0, s>>>(part, G, n, max_in, sumexp_in, max_out,
                                      sumexp_out);
  return cudaGetLastError();
}

}  // namespace eig_fold
