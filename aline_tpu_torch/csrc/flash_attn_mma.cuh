// bfloat16 tensor-core building blocks of the role-masked flash-attention
// kernels in bfloat16 (flash_attn_fwd.cu flash_attn_fwd_bf16_kernel,
// flash_attn_bwd.cu flash_attn_bwd_{dq,dkdv}_bf16_kernel).
//
// A warp owns 16 consecutive positions of row_perm (or, in the backward's
// dK/dV pass, of key_perm): the m16 side of mma.sync.  Thread (g, tq) =
// (lane / 4, lane % 4) holds the accumulator elements of rows g and g + 8,
// columns 2 tq and 2 tq + 1 of every m16n8 tile.  The other operand is a
// tile of rows gathered into shared memory ([kTile, SROW] bfloat16, rows
// padded to SROW so that ldmatrix reads them without bank conflicts), read
// by ldmatrix either as the n side (mma_nt: S = Q Kᵀ, dP = dO Vᵀ and their
// transposes) or, transposed, as the k side (mma_split_t: P V, dS K, Pᵀ dO,
// dSᵀ Q).
//
// Arithmetic.  A product of two bfloat16 values is exact in float32, so
// S and dP on the bf16 tensor cores (m16n8k8 at dh = 8, m16n8k16 over dh /
// 16 steps above) are float32 sums of exact products.  P and dS are
// float32 and must stay so: split3 cuts each into three bfloat16 pieces
// x0 + x1 + x2 == x (exactly: x0 is x with its low 16 bits cleared, 8
// significant bits; x - x0 is exact and has at most 16, of which x1 takes
// the top 8 and x2 the rest), and a piece times a bfloat16 value is again
// exact, so three m16n8k16 products into a float32 accumulator give the
// float32 product up to the order of the sums.  Two C tiles of an S-shaped
// product (16 rows x 16 columns) are the A fragment of one m16n8k16, so P
// and dS never leave registers.
//
// Scores are kept in log2 units (s * scale * log2 e) and exponentiated by
// ex2.approx; a masked pair's score is kNeg2 = -1e9 * log2 e (-1e9 in
// natural units, as the TPU kernel replaces it) and a position past N
// scores -inf, which adds no term at all.

#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_attn_common.cuh"

namespace flash {
namespace mma {

constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;      // rows (key columns) a CTA
constexpr int kTile = 64;               // keys (rows) a ring stage
constexpr int kChunks = kTile / 16;     // 16-wide chunks a stage
constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kNeg2 = kNeg * kLog2e;  // a replaced score in log2 units

template <int DH>
struct Shape {
  static constexpr int SROW = DH == 8 ? DH : DH + 8;  // shared row stride
  static constexpr int KS = DH == 8 ? 1 : DH / 16;     // k-steps over dh
  static constexpr int NT = DH / 8;                    // n8 tiles over dh
  // the backward's dK/dV pass: warps that share 16 key columns, each
  // summing dK and dV over NT / WAYS of the n8 tiles.  At dh = 128 two
  // [16, 128] float32 accumulators beside the k and v fragments would take
  // more than the 255 registers a thread has; two warps then score the
  // same keys and split the dims.
  static constexpr int WAYS = DH >= 128 ? 2 : 1;
  static constexpr int NTW = NT / WAYS;
  // a ring stage's bytes: kTile rows of SROW bfloat16
  static constexpr int STAGE_BYTES = kTile * SROW * 2;
};

__device__ __forceinline__ int ceil16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes into shared memory, zeros (and no read) where !ok
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(ok ? 4 : 0));
}

// Positions [p0, p0 + n) of perm: rows of the [N, DH] arrays a and b into
// shared [n, SROW] tiles, zeros for positions at or past N.
template <int DH>
__device__ __forceinline__ void gather_tiles(bf16* sa, bf16* sb, const bf16* a,
                                             const bf16* b, const int* perm,
                                             int p0, int n, int N) {
  constexpr int V = DH / 8, SROW = Shape<DH>::SROW;   // 16-byte copies a row
  for (int t = threadIdx.x; t < n * V; t += kThreads) {
    const int s = t / V, c = t - s * V;
    const bool ok = p0 + s < N;
    const size_t src = ok ? (size_t)perm[p0 + s] * DH + 8 * c : 0;
    cp_async16_zfill(sa + s * SROW + 8 * c, a + src, ok);
    cp_async16_zfill(sb + s * SROW + 8 * c, b + src, ok);
  }
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b: m16n8k8 and m16n8k16, bfloat16 operands, float32 accumulator
__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t* a,
                                       uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The A fragments of this thread's rows row[0] (g) and row[1] (g + 8) of
// the [*, DH] bfloat16 array x in global memory; a row < 0 reads as zeros.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[Shape<DH>::KS][4],
                                       const bf16* x, const int (&row)[2],
                                       int tq) {
  auto word = [&](int h, int d) -> uint32_t {
    return row[h] < 0 ? 0u
                      : *reinterpret_cast<const uint32_t*>(
                            x + (size_t)row[h] * DH + d);
  };
#pragma unroll
  for (int s = 0; s < Shape<DH>::KS; ++s) {
    a[s][0] = word(0, 16 * s + 2 * tq);
    a[s][1] = word(1, 16 * s + 2 * tq);
    a[s][2] = DH == 8 ? 0u : word(0, 16 * s + 8 + 2 * tq);
    a[s][3] = DH == 8 ? 0u : word(1, 16 * s + 8 + 2 * tq);
  }
}

// c = A X[r0, r0 + 16)ᵀ, the tile's rows as the n side: two m16n8 tiles
// (rows r0 .. r0 + 7 of X, then r0 + 8 .. r0 + 15) over DH.
template <int DH>
__device__ __forceinline__ void mma_nt(float (&c)[2][4],
                                       const uint32_t (&a)[Shape<DH>::KS][4],
                                       const bf16* x, int r0, int lane) {
  constexpr int SROW = Shape<DH>::SROW;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[t][e] = 0.f;
  if constexpr (DH == 8) {
    uint32_t b[2];
    ldsm_x2(b, x + (r0 + (lane & 15)) * SROW);
    mma_k8(c[0], a[0], b[0]);
    mma_k8(c[1], a[0], b[1]);
  } else {
    // matrices: (rows 0-7, dims 16s), (0-7, 16s + 8), (8-15, 16s),
    // (8-15, 16s + 8)
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int s = 0; s < Shape<DH>::KS; ++s) {
      uint32_t b[4];
      ldsm_x4(b, x + (r0 + 8 * (mi >> 1) + r) * SROW + 16 * s + 8 * (mi & 1));
      mma_k16(c[0], a[s], b[0], b[1]);
      mma_k16(c[1], a[s], b[2], b[3]);
    }
  }
}

// The three bfloat16 pieces of a float32 16 x 16 operand held as two C
// tiles, as A fragments: w[p] holds piece p, x == w[0] + w[1] + w[2].
__device__ __forceinline__ void split3(uint32_t (&w)[3][4],
                                       const float (&c)[2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // A fragment word i: C tile i / 2, elements 2 (i % 2) and 2 (i % 2) + 1
    float lo = c[i >> 1][2 * (i & 1)], hi = c[i >> 1][2 * (i & 1) + 1];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint32_t ulo = __float_as_uint(lo), uhi = __float_as_uint(hi);
      w[p][i] = __byte_perm(ulo, uhi, 0x7632);   // both high halves
      lo -= __uint_as_float(ulo & 0xffff0000u);  // exact
      hi -= __uint_as_float(uhi & 0xffff0000u);
    }
  }
}

// acc += (w[0] + w[1] + w[2]) X[r0, r0 + 16), the tile's rows as the k
// side, over NTS n8 tiles of the DH columns of X from tile u0 (all of them
// by default): three m16n8k16 products, smallest first.
template <int DH, int NTS = Shape<DH>::NT>
__device__ __forceinline__ void mma_split_t(float (&acc)[NTS][4],
                                            const uint32_t (&w)[3][4],
                                            const bf16* x, int r0, int lane,
                                            int u0 = 0) {
  constexpr int SROW = Shape<DH>::SROW, NT = Shape<DH>::NT;
  if constexpr (NT == 1) {
    uint32_t b[2];
    ldsm_x2_t(b, x + (r0 + (lane & 15)) * SROW);
#pragma unroll
    for (int p = 2; p >= 0; --p) mma_k16(acc[0], w[p], b[0], b[1]);
  } else {
    // matrices: (rows 0-7, dims 8u), (8-15, 8u), (0-7, 8u + 8), (8-15,
    // 8u + 8), transposed
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int u = 0; u < NTS; u += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, x + (r0 + 8 * (mi & 1) + r) * SROW +
                       8 * (u0 + u + (mi >> 1)));
#pragma unroll
      for (int p = 2; p >= 0; --p) {
        mma_k16(acc[u], w[p], b[0], b[1]);
        mma_k16(acc[u + 1], w[p], b[2], b[3]);
      }
    }
  }
}

template <int NTS>
__device__ __forceinline__ void zero(float (&acc)[NTS][4]) {
#pragma unroll
  for (int u = 0; u < NTS; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
}

// The log2-unit score of a pair that the walk reaches: d * c2 where the
// role codes allow it, the replaced kNeg2 where they mask it, -inf where
// the key or the row does not exist.
__device__ __forceinline__ float walk_score(float d, float c2, bool exists,
                                            bool allowed) {
  return exists ? (allowed ? d * c2 : kNeg2) : -CUDART_INF_F;
}

// acc's rows as bfloat16 pairs: rows row[0] (elements 0, 1 of each
// m16n8 tile) and row[1] (2, 3), columns 8 (u0 + u) + d and + 1 of the
// [*, DH] array x, each times mul[h]; rows < 0 are skipped
template <int DH, int NTS = Shape<DH>::NT>
__device__ __forceinline__ void store_rows(bf16* x, const float (&acc)[NTS][4],
                                           const int (&row)[2], int d,
                                           const float (&mul)[2],
                                           int u0 = 0) {
#pragma unroll
  for (int u = 0; u < NTS; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] >= 0)
        *reinterpret_cast<__nv_bfloat162*>(x + (size_t)row[h] * DH +
                                           8 * (u0 + u) + d) =
            __floats2bfloat162_rn(acc[u][2 * h] * mul[h],
                                  acc[u][2 * h + 1] * mul[h]);
}

}  // namespace mma
}  // namespace flash
