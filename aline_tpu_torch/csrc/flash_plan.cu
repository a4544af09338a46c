// The plan of the role mask that the flash-attention kernels walk, for
// Hopper (sm_90a).
//
// No TPU kernel does this: the Pallas kernels (aline_tpu/ops/
// flash_attention.py:43, :65) score every (row, key) pair and mask them.
// The CUDA kernels score only the pairs the mask allows, and this kernel
// lists them once per encoder forward (all layers and heads share it).
// For the role codes kcode, qrow [B, N] (int32) it writes, per batch row b,
//
//     key_perm[b] = the keys of code 1, then of code 2, then the rest
//     row_perm[b] = the rows with qrow == 1, then the rest
//     n_ctx[b], n_vis[b] = the keys of code 1, of code 1 or 2
//     n_query[b] = the rows with qrow == 1
//     dense[b] = 1 where some row sees no key: a non-query row when
//                n_ctx = 0, a query row when n_vis = 0
//
// each group in index order (a stable partition).  Equal, element for
// element, to the stable argsort of the plain version in
// ops/flash_attention.py.
//
// What bounds it.  It reads 8 bytes and writes 8 bytes per (b, token), a
// few microseconds at the eval shape (B=100, N=2103): launch latency.
// Design: one CTA per batch row.  A first sweep counts the groups; a second
// sweep walks the row in chunks of kPlanThreads tokens, ranks each token
// within its group by a warp ballot and the warps' counts before it, and
// scatters it to its group's start plus its rank.  No atomics, so the plan
// is the same on every call.

#include <cuda_runtime.h>

namespace {

constexpr int kPlanThreads = 256;
constexpr int kWarps = kPlanThreads / 32;

__global__ void __launch_bounds__(kPlanThreads)
flash_plan_kernel(const int* __restrict__ kcode, const int* __restrict__ qrow,
                  int* __restrict__ key_perm, int* __restrict__ row_perm,
                  int* __restrict__ n_ctx, int* __restrict__ n_vis,
                  int* __restrict__ n_query, int* __restrict__ dense, int N) {
  __shared__ int counts[kWarps][3];   // per warp: code 1, code 2, query rows
  __shared__ int totals[3];
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int* kc = kcode + (size_t)b * N;
  const int* qr = qrow + (size_t)b * N;

  // sweep 1: the size of each group
  int c1 = 0, c2 = 0, cq = 0;
  for (int i = threadIdx.x; i < N; i += kPlanThreads) {
    c1 += kc[i] == 1;
    c2 += kc[i] == 2;
    cq += qr[i] == 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c1 += __shfl_xor_sync(0xffffffffu, c1, off);
    c2 += __shfl_xor_sync(0xffffffffu, c2, off);
    cq += __shfl_xor_sync(0xffffffffu, cq, off);
  }
  if (lane == 0) {
    counts[warp][0] = c1;
    counts[warp][1] = c2;
    counts[warp][2] = cq;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += counts[w][threadIdx.x];
    totals[threadIdx.x] = s;
  }
  __syncthreads();
  const int nc = totals[0], nv = totals[0] + totals[1], nq = totals[2];
  if (threadIdx.x == 0) {
    n_ctx[b] = nc;
    n_vis[b] = nv;
    n_query[b] = nq;
    dense[b] = (nc == 0 && nq < N) || (nv == 0 && nq > 0);
  }

  // sweep 2: rank each token in its group, in index order
  const unsigned below = (1u << lane) - 1u;
  int run1 = 0, run2 = 0, runq = 0;     // group members in earlier chunks
  for (int i0 = 0; i0 < N; i0 += kPlanThreads) {
    const int i = i0 + threadIdx.x;
    const bool live = i < N;
    const int code = live ? kc[i] : 0;
    const bool is1 = live && code == 1, is2 = live && code == 2;
    const bool isq = live && qr[i] == 1;
    const unsigned m1 = __ballot_sync(0xffffffffu, is1);
    const unsigned m2 = __ballot_sync(0xffffffffu, is2);
    const unsigned mq = __ballot_sync(0xffffffffu, isq);
    __syncthreads();                    // the last chunk's counts are read
    if (lane == 0) {
      counts[warp][0] = __popc(m1);
      counts[warp][1] = __popc(m2);
      counts[warp][2] = __popc(mq);
    }
    __syncthreads();
    int r1 = run1 + __popc(m1 & below), r2 = run2 + __popc(m2 & below);
    int rq = runq + __popc(mq & below);
    for (int w = 0; w < kWarps; ++w) {
      const bool before = w < warp;
      r1 += before ? counts[w][0] : 0;
      r2 += before ? counts[w][1] : 0;
      rq += before ? counts[w][2] : 0;
      run1 += counts[w][0];
      run2 += counts[w][1];
      runq += counts[w][2];
    }
    if (live) {
      // tokens before i: r1 of code 1, r2 of code 2, the rest of code 0
      const int key_pos = is1 ? r1 : (is2 ? nc + r2 : nv + (i - r1 - r2));
      key_perm[(size_t)b * N + key_pos] = i;
      const int row_pos = isq ? rq : nq + (i - rq);
      row_perm[(size_t)b * N + row_pos] = i;
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  kcode, qrow, key_perm, row_perm [B, N]
// and n_ctx, n_vis, n_query, dense [B]: device pointers to contiguous int32
// arrays.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_plan(const void* kcode, const void* qrow, void* key_perm,
                          void* row_perm, void* n_ctx, void* n_vis,
                          void* n_query, void* dense, int B, int N,
                          void* stream) {
  if (B <= 0 || N <= 0) return 0;
  flash_plan_kernel<<<B, kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(kcode), static_cast<const int*>(qrow),
      static_cast<int*>(key_perm), static_cast<int*>(row_perm),
      static_cast<int*>(n_ctx), static_cast<int*>(n_vis),
      static_cast<int*>(n_query), static_cast<int*>(dense), N);
  return (int)cudaGetLastError();
}
