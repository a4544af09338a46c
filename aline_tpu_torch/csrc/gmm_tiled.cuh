// The tiled form of the fused GMM-head kernels (gmm_head_fwd.cu,
// gmm_head_bwd.cu): the widths where W1[c] does not fit in shared memory
// (D a multiple of 128 and F a multiple of 128, e.g. D = 1024, F = 4096:
// 16 MiB a component).  The narrow kernels stage all of W1[c] and keep the
// rank-3 output sum in registers; here every product is a tiled matrix
// product whose epilogue does the rest.
//
// One mainloop serves every product: C[128 x 128] = A[128 x K] . B[K x 128]
// for one CTA of 8 warps (4 along M x 2 along N, a warp 32 x 64: 2 x 8
// m16n8 tiles, so a thread holds few rows and the forward's epilogue keeps
// their 3 outputs in registers across F), K in steps of 32, a ring of
// kStages shared-memory stages filled by 16-byte cp.async, each product as
// 3xTF32 on mma.sync.m16n8k8
// (gmm_head_common.cuh: float32 accuracy; the operands are split into
// (hi, lo) as the fragments are read).  A and B each come in either layout
// of device memory, so the same loop computes Z . W1[c] (the pre-
// activation), dh . W1[c]^T (dz) and Z^T . dh (dW1):
//   A: kMK (element (m, k) at m * lda + k) or kKM (at k * lda + m)
//   B: kKN (element (k, n) at k * ldb + n) or kNK (at n * ldb + k)
// A tile sits in shared memory as [outer][inner], inner the contiguous axis
// of device memory, with a row stride of inner + 4 (inner = 32) or inner +
// 8 (inner = 128): every fragment read of a warp then hits 32 distinct
// banks.  Only an outer index may be ragged (the token rows: M of the
// forward and dz, K of dW1); rows past the end read zeros.
//
// The sums of a C element run over K in order, each 32-step as the 4
// k-steps of 8 in order, each product as lo.hi, hi.lo, hi.hi: the same
// inputs and shape give bitwise the same result in any CTA.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_head_common.cuh"

namespace gmm {
namespace tiled {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kMT = 2, kNT = 8;          // m16 and n8 tiles of a warp
constexpr int kStages = 3;
constexpr int kWidth = 128;              // D and F are multiples of this

enum Layout { kMK, kKM, kKN, kNK };

__host__ __device__ constexpr int stride(int inner) {
  return inner + (inner == 32 ? 4 : 8);
}

// The shape of an operand's tile in shared memory
template <Layout L>
struct Tile {
  // A: (M, K); B: (K, N).  The outer axis is the strided one.
  static constexpr bool kA = L == kMK || L == kKM;
  static constexpr int OUTER = (L == kMK) ? kBM : (L == kNK ? kBN : kBK);
  static constexpr int INNER = (L == kMK || L == kNK) ? kBK
                                                      : (kA ? kBM : kBN);
  static constexpr int S = stride(INNER);
  static constexpr int FLOATS = OUTER * S;
};

template <Layout LA, Layout LB>
struct Gemm {
  using TA = Tile<LA>;
  using TB = Tile<LB>;
  static constexpr int STAGE = TA::FLOATS + TB::FLOATS;
  static constexpr size_t SMEM = (size_t)kStages * STAGE * sizeof(float);
};

// Copy rows [o0, o0 + OUTER) x columns [i0, i0 + INNER) of the row-major
// array g (row stride ld) into the tile s; rows at or past o_lim read 0.
template <int OUTER, int INNER>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long ld, long long o0,
                                          long long i0, long long o_lim) {
  constexpr int V = INNER / 4;           // 16-byte chunks a row
  constexpr int S = stride(INNER);
#pragma unroll
  for (int c = threadIdx.x; c < OUTER * V; c += kThreads) {
    const int o = c / V, i = 4 * (c - o * V);
    const bool ok = o0 + o < o_lim;
    const float* src = ok ? g + (o0 + o) * ld + i0 + i : g;
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(s + o * S + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

// element (r, k) of the A tile, (k, n) of the B tile
template <Layout L>
__device__ __forceinline__ float at(const float* s, int x, int y) {
  // A: x = m, y = k; B: x = k, y = n
  if constexpr (L == kMK) return s[x * Tile<L>::S + y];
  if constexpr (L == kKM) return s[y * Tile<L>::S + x];
  if constexpr (L == kKN) return s[x * Tile<L>::S + y];
  return s[y * Tile<L>::S + x];          // kNK
}

// The warp's 32 x 64 block of C, as mma accumulator fragments: element
// (mt, nt, e) is row 32 wm + 16 mt + g + 8 (e >> 1), column 64 wn + 8 nt +
// 2 t + (e & 1) of the CTA's tile.
struct Acc {
  float v[kMT][kNT][4];
};

__device__ __forceinline__ int warp_m() { return (threadIdx.x >> 5) / 2; }
__device__ __forceinline__ int warp_n() { return (threadIdx.x >> 5) % 2; }

// acc = A[m0 .., :K] . B[:K, n0 ..] for the CTA's 128 x 128 tile.  lda and
// ldb are the row strides of A and B in device memory; m_lim and K bound
// the ragged outer axes (rows past them read 0).  smem holds
// Gemm<LA, LB>::SMEM bytes.  Ends with every copy landed and the CTA
// synchronised, so the caller may reuse smem.
template <Layout LA, Layout LB>
__device__ __forceinline__ void mainloop(Acc& acc, const float* __restrict__ A,
                                         long long lda,
                                         const float* __restrict__ B,
                                         long long ldb, long long m0,
                                         long long n0, long long m_lim,
                                         long long K, float* smem) {
  using G = Gemm<LA, LB>;
  using TA = typename G::TA;
  using TB = typename G::TB;
  const int nk = (int)((K + kBK - 1) / kBK);
  auto load_stage = [&](int kt) {
    float* sa = smem + (kt % kStages) * G::STAGE;
    float* sb = sa + TA::FLOATS;
    const long long k0 = (long long)kt * kBK;
    if constexpr (LA == kMK)
      load_tile<TA::OUTER, TA::INNER>(sa, A, lda, m0, k0, m_lim);
    else
      load_tile<TA::OUTER, TA::INNER>(sa, A, lda, k0, m0, K);
    if constexpr (LB == kKN)
      load_tile<TB::OUTER, TB::INNER>(sb, B, ldb, k0, n0, K);
    else
      load_tile<TB::OUTER, TB::INNER>(sb, B, ldb, n0, k0, 1LL << 62);
  };
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[mt][nt][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  const int g = lane_g(), t = lane_t();
  const int rm = 32 * warp_m(), cn = 64 * warp_n();
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);
    cp_async_commit();
    const float* sa = smem + (kt % kStages) * G::STAGE;
    const float* sb = sa + TA::FLOATS;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      // the warp's A fragments of this k-step, then one B fragment at a
      // time: few registers beside the accumulators
      FragA a[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = rm + 16 * mt + g, k = 8 * ks + t;
        const float v[4] = {at<LA>(sa, r, k), at<LA>(sa, r + 8, k),
                            at<LA>(sa, r, k + 4), at<LA>(sa, r + 8, k + 4)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = split_tf32(v[i]);
          a[mt].hi[i] = __float_as_uint(x.x);
          a[mt].lo[i] = __float_as_uint(x.y);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int k = 8 * ks + t, n = cn + 8 * nt + g;
        const float2 x0 = split_tf32(at<LB>(sb, k, n));
        const float2 x1 = split_tf32(at<LB>(sb, k + 4, n));
        FragB b;
        b.hi[0] = __float_as_uint(x0.x);
        b.lo[0] = __float_as_uint(x0.y);
        b.hi[1] = __float_as_uint(x1.x);
        b.lo[1] = __float_as_uint(x1.y);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(acc.v[mt][nt], a[mt], b);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// The CTA-tile row and column of accumulator element (mt, nt, e)
__device__ __forceinline__ int acc_row(int mt, int e) {
  return 32 * warp_m() + 16 * mt + lane_g() + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int nt, int e) {
  return 64 * warp_n() + 8 * nt + 2 * lane_t() + (e & 1);
}

// The widths the tiled kernels take
__host__ __device__ inline bool takes(int D, int F) {
  return D > 0 && F > 0 && D % kWidth == 0 && F % kWidth == 0;
}

}  // namespace tiled
}  // namespace gmm
