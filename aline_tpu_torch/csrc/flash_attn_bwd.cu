// Role-masked flash-attention backward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel aline_tpu/ops/flash_attention.py:65
// (_bwd_kernel, entered through _flash_bwd).  From q, k, v, the role codes,
// the forward's O and row logsumexp lse, and dO = dL/dO it computes, with
// the forward's replaced scores s_ij (see flash_attn_fwd.cu),
//
//     P_ij = exp(s_ij - lse_i)        (on every column, masked ones too)
//     D_i  = sum_d dO_id O_id
//     dS_ij = P_ij ((dO_i . v_j) - D_i)
//     dQ_i = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i,
//     dV_j = sum_i P_ij dO_i
//
// over the N real rows and columns: the padded columns have k = v = 0 and
// add nothing to dQ, their dK and dV are discarded, and padded rows (lse =
// 0 in the TPU kernel) are not visited.
//
// What bounds it.  10*B*H*N^2*dh float32 FMA operations (five products of
// N x N x dh each, counting the recomputed scores) and two exps per score
// against 7 arrays of B*H*N*dh floats moved: at the training shape (B=200,
// H=4, N=303, dh=8) 5.9 GFLOP over 31 MB, about 190 FLOP per byte, so the
// float32 FMA rate (67 TFLOP/s on an H100 SXM) bounds it before memory.
// The mask lets through about a quarter of those pairs there; scoring
// only those is later work.
//
// Design.  The TPU kernel sums dK and dV over q-blocks into output blocks
// that every grid step revisits, zeroed at the first step: it relies on
// the TPU running the grid in order.  Here blocks run in any order, so the
// gradient is two passes, and each gradient element is summed by one
// thread in a fixed order (no atomics: bitwise repeatable):
//  * pass 1, one CTA per (b, h, block of query rows): a row group keeps
//    q_i, dO_i and dQ_i in registers, computes D_i from O_i and dO_i (and
//    writes it for pass 2), and streams K, V and kcode through shared
//    memory tiles of 64 keys;
//  * pass 2, one CTA per (b, h, block of key columns): a column group keeps
//    k_j, v_j, dK_j and dV_j in registers and streams q, dO, lse, D and
//    qrow through shared memory tiles of 64 rows.
// A row or column is owned by G = dh/16 lanes (G = 1 for dh <= 16), each
// with dh/G dims; dots are the group's partial dots summed with
// xor-shuffles.  Both passes take their scores from the forward's own
// masked_score (flash_attn_common.cuh), so they recompute the forward's
// scores bit for bit.  Tensor cores and skipping
// tiles that kcode masks for every row are later work.

#include <cuda_runtime.h>
#include <limits.h>

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

// Pass 1: dQ and D, one thread group per query row.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ kcode,
                         const int* __restrict__ qrow,
                         const float* __restrict__ o,
                         const float* __restrict__ lse,
                         const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ delta,
                         int H, int N, float scale, int n_blocks) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  constexpr int ROWS = Split<DH>::ROWS;
  __shared__ float4 ks[kTile * DH / 4];
  __shared__ float4 vs[kTile * DH / 4];
  __shared__ int cs[kTile];

  const int bh = blockIdx.x / n_blocks;
  const int b = bh / H;
  const int part = threadIdx.x % G;
  const int i = (blockIdx.x % n_blocks) * ROWS + threadIdx.x / G;
  const bool live = i < N;
  const size_t head = (size_t)bh * N * DH;
  const size_t row = head + (size_t)i * DH + part * DPT;

  float qr[DPT], dor[DPT], acc[DPT];
  load_dims<DPT / 4>(qr, q + row, live);
  load_dims<DPT / 4>(dor, dout + row, live);
  load_dims<DPT / 4>(acc, o + row, live);       // O_i, for D_i only
  float d_i = 0.f;
#pragma unroll
  for (int d = 0; d < DPT; ++d) d_i = fmaf(dor[d], acc[d], d_i);
  d_i = group_sum<G>(d_i);
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  const float lse_i = live ? lse[(size_t)bh * N + i] : 0.f;
  const bool is_query = live && qrow[(size_t)b * N + i] == 1;
  if (live && part == 0) delta[(size_t)bh * N + i] = d_i;

  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int n = min(kTile, N - j0);
    __syncthreads();
    const float4* k4 = reinterpret_cast<const float4*>(k + head + (size_t)j0 * DH);
    const float4* v4 = reinterpret_cast<const float4*>(v + head + (size_t)j0 * DH);
    for (int t = threadIdx.x; t < n * DH / 4; t += kThreads) {
      ks[t] = k4[t];
      vs[t] = v4[t];
    }
    for (int t = threadIdx.x; t < n; t += kThreads)
      cs[t] = kcode[(size_t)b * N + j0 + t];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {               // n is uniform in the CTA
      const float4* kr = ks + j * (DH / 4) + part * (DPT / 4);
      const float4* vr = vs + j * (DH / 4) + part * (DPT / 4);
      const float s = masked_score<DH>(qr, kr, scale, cs[j], is_query);
      const float p = expf(s - lse_i);
      const float dp = group_sum<G>(dot_dims<DPT / 4>(dor, vr));
      axpy_dims<DPT / 4>(acc, p * (dp - d_i), kr);
    }
  }
  if (live) store_dims<DPT / 4>(dq + row, acc, scale);
}

// Pass 2: dK and dV, one thread group per key column.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkdv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ kcode,
                           const int* __restrict__ qrow,
                           const float* __restrict__ lse,
                           const float* __restrict__ dout,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int N, float scale, int n_blocks) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  constexpr int ROWS = Split<DH>::ROWS;
  __shared__ float4 qs[kTile * DH / 4];
  __shared__ float4 dos[kTile * DH / 4];
  __shared__ float lses[kTile];
  __shared__ float deltas[kTile];
  __shared__ int qrs[kTile];

  const int bh = blockIdx.x / n_blocks;
  const int b = bh / H;
  const int part = threadIdx.x % G;
  const int j = (blockIdx.x % n_blocks) * ROWS + threadIdx.x / G;
  const bool live = j < N;
  const size_t head = (size_t)bh * N * DH;
  const size_t col = head + (size_t)j * DH + part * DPT;

  float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
  load_dims<DPT / 4>(kr, k + col, live);
  load_dims<DPT / 4>(vr, v + col, live);
#pragma unroll
  for (int d = 0; d < DPT; ++d) dkr[d] = dvr[d] = 0.f;
  const int kc = live ? kcode[(size_t)b * N + j] : 0;

  for (int i0 = 0; i0 < N; i0 += kTile) {
    const int n = min(kTile, N - i0);
    __syncthreads();
    const float4* q4 = reinterpret_cast<const float4*>(q + head + (size_t)i0 * DH);
    const float4* d4 = reinterpret_cast<const float4*>(dout + head + (size_t)i0 * DH);
    for (int t = threadIdx.x; t < n * DH / 4; t += kThreads) {
      qs[t] = q4[t];
      dos[t] = d4[t];
    }
    for (int t = threadIdx.x; t < n; t += kThreads) {
      lses[t] = lse[(size_t)bh * N + i0 + t];
      deltas[t] = delta[(size_t)bh * N + i0 + t];
      qrs[t] = qrow[(size_t)b * N + i0 + t];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {               // n is uniform in the CTA
      const float4* qi = qs + i * (DH / 4) + part * (DPT / 4);
      const float4* di = dos + i * (DH / 4) + part * (DPT / 4);
      const float s = masked_score<DH>(kr, qi, scale, kc, qrs[i] == 1);
      const float p = expf(s - lses[i]);
      axpy_dims<DPT / 4>(dvr, p, di);
      const float dp = group_sum<G>(dot_dims<DPT / 4>(vr, di));
      axpy_dims<DPT / 4>(dkr, p * (dp - deltas[i]), qi);
    }
  }
  if (!live) return;
  store_dims<DPT / 4>(dk + col, dkr, scale);
  store_dims<DPT / 4>(dv + col, dvr, 1.f);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* kcode, const int* qrow, const float* o,
                   const float* lse, const float* dout, float* dq, float* dk,
                   float* dv, float* delta, int B, int H, int N, float scale,
                   cudaStream_t stream) {
  constexpr int ROWS = Split<DH>::ROWS;
  const int n_blocks = (N + ROWS - 1) / ROWS;
  const long long ctas = (long long)B * H * n_blocks;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_attn_bwd_dq_kernel<DH><<<(unsigned)ctas, kThreads, 0, stream>>>(
      q, k, v, kcode, qrow, o, lse, dout, dq, delta, H, N, scale, n_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // same stream: pass 2 reads the D that pass 1 wrote
  flash_attn_bwd_dkdv_kernel<DH><<<(unsigned)ctas, kThreads, 0, stream>>>(
      q, k, v, kcode, qrow, lse, dout, delta, dk, dv, H, N, scale, n_blocks);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous, 16-byte aligned arrays: q, k, v, o, dout, dq, dk, dv
// [B, H, N, dh] and lse, delta (scratch for D) [B, H, N] float32; kcode and
// qrow [B, N] int32.  Returns the cudaError_t of the launches (0 =
// launched).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* kcode, const void* qrow,
                              const void* o, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int B, int H, int N, int dh,
                              float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* kc = static_cast<const int*>(kcode);
  const int* qr = static_cast<const int*>(qrow);
  const float* of = static_cast<const float*>(o);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8: return launch<8>(qf, kf, vf, kc, qr, of, lf, gf, dqf, dkf, dvf, df, B, H, N, scale, s);
    case 16: return launch<16>(qf, kf, vf, kc, qr, of, lf, gf, dqf, dkf, dvf, df, B, H, N, scale, s);
    case 32: return launch<32>(qf, kf, vf, kc, qr, of, lf, gf, dqf, dkf, dvf, df, B, H, N, scale, s);
    case 64: return launch<64>(qf, kf, vf, kc, qr, of, lf, gf, dqf, dkf, dvf, df, B, H, N, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
