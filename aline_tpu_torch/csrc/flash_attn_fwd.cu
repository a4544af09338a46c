// Role-masked flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel aline_tpu/ops/flash_attention.py:43
// (_fwd_kernel, entered through flash_role_attention and _flash_fwd).  For
// q, k, v [B, H, N, dh] and the role codes kcode, qrow [B, N] (int32) it
// computes, per (b, h) and query row i,
//
//     allowed(i, j) = kcode[j] == 1 || (qrow[i] == 1 && kcode[j] == 2)
//     s_ij = allowed(i, j) ? (q_i . k_j) * scale : -1e9      (replaced)
//     o_i  = sum_j exp(s_ij - m_i) v_j / l_i,   lse_i = m_i + log(l_i)
//
// over the Np = ceil(N / bq) * bq columns of the TPU kernel's padded grid.
// The Np - N padded columns (the wrapper passes their count) are invisible
// and have v = 0: they change nothing unless row i sees no key at all, and
// then the row averages v over Np columns, as the TPU kernel does.
//
// What bounds it.  At the eval shape (B=100, H=4, N=2103, dh=8) this
// kernel scores every pair: 4*B*H*N^2*dh = 57 GFLOP of float32 FMAs (and
// one exp per score) over 54 MB of inputs and outputs, so the float32 FMA
// rate outside the tensor cores (67 TFLOP/s on an H100 SXM) bounds it, not
// memory.  The mask lets through only about 5% of those pairs (the query
// pool is invisible to every row), so the work the function needs is
// about 3 GFLOP: skipping the key tiles that kcode masks is the lever.
//
// Design (simple and exact first; tensor cores and skipping the key tiles
// that kcode masks for every row are later work):
//  * One CTA of 128 threads per (b, h, block of query rows).  A row is
//    owned by a group of G = dh/16 lanes (G = 1 for dh <= 16); each lane
//    keeps DPT = dh/G of the row's q and accumulator dims in registers,
//    and a score is the group's partial dots summed with xor-shuffles.
//  * K, V and kcode stream through shared memory in tiles of 64 keys, so
//    any N runs: the TPU kernel keeps all N keys in VMEM and a [bq, N]
//    score tile (1 MB at N = 2103), which no SM could hold.  All groups of
//    a warp read the same key row, so shared reads are broadcasts.
//  * Online softmax in chunks of keys: the chunk's scores stay in
//    registers, the running max moves once per chunk, and the accumulator
//    and the row sum are rescaled once per chunk.
//  * A masked score is replaced by -1e9 (not offset), the output divided
//    by the row sum and lse = m + log(l), as in the TPU kernel.  The score
//    comes from masked_score (flash_attn_common.cuh), which the backward's
//    passes call too.

#include <cuda_runtime.h>
#include <limits.h>

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ kcode,
                      const int* __restrict__ qrow, float* __restrict__ o,
                      float* __restrict__ lse, int H, int N, int n_pad,
                      float scale, int n_blocks) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  constexpr int ROWS = Split<DH>::ROWS;
  constexpr int kChunk = DH <= 16 ? 16 : 8;
  __shared__ float4 ks[kTile * DH / 4];
  __shared__ float4 vs[kTile * DH / 4];
  __shared__ int cs[kTile];

  const int bh = blockIdx.x / n_blocks;
  const int b = bh / H;
  const int part = threadIdx.x % G;
  const int i = (blockIdx.x % n_blocks) * ROWS + threadIdx.x / G;
  const bool live = i < N;
  const size_t head = (size_t)bh * N * DH;      // (b, h) in q, k, v, o

  float qr[DPT], acc[DPT];
  load_dims<DPT / 4>(qr, q + head + (size_t)i * DH + part * DPT, live);
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  const bool is_query = live && qrow[(size_t)b * N + i] == 1;
  float m = kNeg, l = 0.f;  // every score is >= -1e9, so m starts there

  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int n = min(kTile, N - j0);           // the same in the whole CTA
    __syncthreads();                            // the last tile is consumed
    const float4* k4 = reinterpret_cast<const float4*>(k + head + (size_t)j0 * DH);
    const float4* v4 = reinterpret_cast<const float4*>(v + head + (size_t)j0 * DH);
    for (int t = threadIdx.x; t < n * DH / 4; t += kThreads) {
      ks[t] = k4[t];
      vs[t] = v4[t];
    }
    for (int t = threadIdx.x; t < n; t += kThreads)
      cs[t] = kcode[(size_t)b * N + j0 + t];
    __syncthreads();

    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float s[kChunk];
      float mc = kNeg;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        s[u] = kNeg;
        if (c0 + u < n) {                       // uniform: shuffles are safe
          s[u] = masked_score<DH>(
              qr, ks + (c0 + u) * (DH / 4) + part * (DPT / 4), scale,
              cs[c0 + u], is_query);
          mc = fmaxf(mc, s[u]);
        }
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
      m = m_new;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (c0 + u < n) {
          const float p = expf(s[u] - m);
          l += p;
          axpy_dims<DPT / 4>(acc, p,
                             vs + (c0 + u) * (DH / 4) + part * (DPT / 4));
        }
      }
    }
  }
  // the padded columns: score -1e9, v = 0
  l += (float)n_pad * expf(kNeg - m);
  if (!live) return;
  float4* dst = reinterpret_cast<float4*>(o + head + (size_t)i * DH + part * DPT);
#pragma unroll
  for (int d4 = 0; d4 < DPT / 4; ++d4)
    dst[d4] = make_float4(acc[4 * d4 + 0] / l, acc[4 * d4 + 1] / l,
                          acc[4 * d4 + 2] / l, acc[4 * d4 + 3] / l);
  if (part == 0) lse[(size_t)bh * N + i] = m + logf(l);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* kcode, const int* qrow, float* o, float* lse,
                   int B, int H, int N, int n_pad, float scale,
                   cudaStream_t stream) {
  constexpr int ROWS = Split<DH>::ROWS;
  const int n_blocks = (N + ROWS - 1) / ROWS;
  const long long ctas = (long long)B * H * n_blocks;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_attn_fwd_kernel<DH><<<(unsigned)ctas, kThreads, 0, stream>>>(
      q, k, v, kcode, qrow, o, lse, H, N, n_pad, scale, n_blocks);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous, 16-byte aligned arrays: q, k, v, o [B, H, N, dh] and lse
// [B, H, N] float32, kcode and qrow [B, N] int32.  n_pad = Np - N.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* kcode, const void* qrow, void* o,
                              void* lse, int B, int H, int N, int n_pad,
                              int dh, float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* kc = static_cast<const int*>(kcode);
  const int* qr = static_cast<const int*>(qrow);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8: return launch<8>(qf, kf, vf, kc, qr, of, lf, B, H, N, n_pad, scale, s);
    case 16: return launch<16>(qf, kf, vf, kc, qr, of, lf, B, H, N, n_pad, scale, s);
    case 32: return launch<32>(qf, kf, vf, kc, qr, of, lf, B, H, N, n_pad, scale, s);
    case 64: return launch<64>(qf, kf, vf, kc, qr, of, lf, B, H, N, n_pad, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
