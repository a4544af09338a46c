// Role-masked flash-attention backward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel aline_tpu/ops/flash_attention.py:65
// (_bwd_kernel, entered through _flash_bwd).  From q, k, v, the forward's O
// and row logsumexp lse, and dO = dL/dO it computes, with the forward's
// replaced scores s_ij (see flash_attn_fwd.cu),
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
// Only the pairs the mask allows are visited, from the mask's plan
// (flash_plan.cu).  For a row that sees some key, lse_i is a real score's
// size, so a masked pair's P_ij = exp(-1e9 - lse_i) is 0 in float32 and adds
// nothing to any gradient.  Where some row of a batch row sees no key
// (plan.dense), that row has P = 1/Np on every column, as in the TPU
// kernel, and every pass walks all N keys and rows of that batch row.
//
// What bounds it.  10·dh FLOP (five products, counting the recomputed
// scores) and two exps per allowed pair: at the training shape (B=200,
// H=4, N=303, dh=8) 26% of the pairs, 1.5 GFLOP, 0.023 ms of float32 FMAs
// at 67 TFLOP/s against 0.019 ms for the 63 MB moved.  As in the forward,
// the instructions a pair takes bound it.
//
// Design.  The TPU kernel sums dK and dV over q-blocks into output blocks
// that every grid step revisits, zeroed at the first step: it relies on
// the TPU running the grid in order.  Here blocks run in any order, so the
// gradient is two passes, and each gradient element is summed by one
// thread group in a fixed order (no atomics: bitwise repeatable):
//  * pass 1, one CTA per (b, h, block of rows in row_perm order): a row
//    group keeps q_i, dO_i and dQ_i in registers, computes D_i from O_i and
//    dO_i (and writes it for pass 2), and walks the keys of key_perm as the
//    forward does (query rows n_vis, the others n_ctx), gathered into a
//    two-stage cp.async ring;
//  * pass 2, one CTA per (b, h, block of positions in key_perm): a column
//    group keeps k_j, v_j, dK_j and dV_j in registers and walks the rows of
//    row_perm, gathered with their lse and D the same way: a context key
//    all N rows, a code-2 key the n_query query rows; a code-0 key walks
//    none and writes dK = dV = 0.
// A row or column is owned by G = dh/16 lanes (G = 1 for dh <= 16), each
// with dh/G dims; dots are the group's partial dots summed with
// xor-shuffles.  Both passes take their scores from the forward's own
// masked_score (flash_attn_common.cuh), so they recompute the forward's
// scores bit for bit.

#include <cuda_runtime.h>
#include <limits.h>

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

// Pass 1: dQ and D, one thread group per row.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, const Plan plan,
                         const float* __restrict__ o,
                         const float* __restrict__ lse,
                         const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ delta,
                         int H, int N, float scale, int n_blocks) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  constexpr int ROWS = Split<DH>::ROWS, TILE = Split<DH>::TILE;
  __shared__ __align__(16) float ks[2][TILE * DH];
  __shared__ __align__(16) float vs[2][TILE * DH];

  const int bh = blockIdx.x / n_blocks;
  const PlanRow pr = plan_row(plan, bh / H, N);
  const int r0 = (blockIdx.x % n_blocks) * ROWS;   // positions in row_perm
  const int part = threadIdx.x % G;
  const int r = r0 + threadIdx.x / G;
  const bool live = r < N;
  const int i = live ? pr.row_perm[r] : 0;
  const size_t head = (size_t)bh * N * DH;
  const size_t row = head + (size_t)i * DH + part * DPT;
  const float* kh = k + head;
  const float* vh = v + head;

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
  const bool is_query = r < pr.n_query;
  if (live && part == 0) delta[(size_t)bh * N + i] = d_i;

  const int n_keys = pr.keys_for(r0);
  const int warp_keys = pr.keys_for(r0 + (threadIdx.x / 32) * (32 / G));
  const int n_tiles = (n_keys + TILE - 1) / TILE;
  if (n_tiles > 0)
    gather_rows<DH>(ks[0], vs[0], kh, vh, pr.key_perm, 0, min(TILE, n_keys));
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * TILE;
    if (t + 1 < n_tiles)
      gather_rows<DH>(ks[(t + 1) & 1], vs[(t + 1) & 1], kh, vh, pr.key_perm,
                      j0 + TILE, min(TILE, n_keys - j0 - TILE));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float4* k4 = reinterpret_cast<const float4*>(ks[t & 1]);
    const float4* v4 = reinterpret_cast<const float4*>(vs[t & 1]);
    const int n = min(TILE, warp_keys - j0);    // uniform in the warp
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4* kr = k4 + j * (DH / 4) + part * (DPT / 4);
      const float4* vr = v4 + j * (DH / 4) + part * (DPT / 4);
      const float s = masked_score<DH>(qr, kr, scale, pr.code(j0 + j),
                                       is_query);
      const float p = expf(s - lse_i);
      const float dp = group_sum<G>(dot_dims<DPT / 4>(dor, vr));
      axpy_dims<DPT / 4>(acc, p * (dp - d_i), kr);
    }
    __syncthreads();
  }
  if (live) store_dims<DPT / 4>(dq + row, acc, scale);
}

// Pass 2: dK and dV, one thread group per key column.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkdv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, const Plan plan,
                           const float* __restrict__ lse,
                           const float* __restrict__ dout,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int N, float scale, int n_blocks) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  constexpr int ROWS = Split<DH>::ROWS, TILE = Split<DH>::TILE;
  __shared__ __align__(16) float qs[2][TILE * DH];
  __shared__ __align__(16) float dos[2][TILE * DH];
  __shared__ float lses[2][TILE];
  __shared__ float deltas[2][TILE];

  const int bh = blockIdx.x / n_blocks;
  const PlanRow pr = plan_row(plan, bh / H, N);
  const int p0 = (blockIdx.x % n_blocks) * ROWS;   // positions in key_perm
  const int part = threadIdx.x % G;
  const int p = p0 + threadIdx.x / G;
  const bool live = p < N;
  const int j = live ? pr.key_perm[p] : 0;
  const int kc = live ? pr.code(p) : 0;
  const size_t head = (size_t)bh * N * DH;
  const size_t col = head + (size_t)j * DH + part * DPT;
  const float* qh = q + head;
  const float* doh = dout + head;
  const float* lseh = lse + (size_t)bh * N;
  const float* deltah = delta + (size_t)bh * N;

  float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
  load_dims<DPT / 4>(kr, k + col, live);
  load_dims<DPT / 4>(vr, v + col, live);
#pragma unroll
  for (int d = 0; d < DPT; ++d) dkr[d] = dvr[d] = 0.f;

  // rows of row_perm [i0, i0 + n) with their lse and D
  auto gather = [&](int stage, int i0, int n) {
    gather_rows<DH>(qs[stage], dos[stage], qh, doh, pr.row_perm, i0, n);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int i = pr.row_perm[i0 + t];
      cp_async4(&lses[stage][t], lseh + i);
      cp_async4(&deltas[stage][t], deltah + i);
    }
  };
  // the CTA walks as far as its first column, a warp as far as its own
  const int n_rows = pr.rows_for(p0);
  const int warp_rows = pr.rows_for(p0 + (threadIdx.x / 32) * (32 / G));
  const int n_tiles = (n_rows + TILE - 1) / TILE;
  if (n_tiles > 0) gather(0, 0, min(TILE, n_rows));
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * TILE;
    if (t + 1 < n_tiles)
      gather((t + 1) & 1, i0 + TILE, min(TILE, n_rows - i0 - TILE));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float4* q4 = reinterpret_cast<const float4*>(qs[t & 1]);
    const float4* d4 = reinterpret_cast<const float4*>(dos[t & 1]);
    const float* lt = lses[t & 1];
    const float* dt = deltas[t & 1];
    const int n = min(TILE, warp_rows - i0);    // uniform in the warp
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float4* qi = q4 + i * (DH / 4) + part * (DPT / 4);
      const float4* di = d4 + i * (DH / 4) + part * (DPT / 4);
      const float s = masked_score<DH>(kr, qi, scale, kc,
                                       i0 + i < pr.n_query);
      const float pij = expf(s - lt[i]);
      axpy_dims<DPT / 4>(dvr, pij, di);
      const float dp = group_sum<G>(dot_dims<DPT / 4>(vr, di));
      axpy_dims<DPT / 4>(dkr, pij * (dp - dt[i]), qi);
    }
    __syncthreads();
  }
  if (!live) return;
  store_dims<DPT / 4>(dk + col, dkr, scale);
  store_dims<DPT / 4>(dv + col, dvr, 1.f);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const Plan& plan, const float* o, const float* lse,
                   const float* dout, float* dq, float* dk, float* dv,
                   float* delta, int B, int H, int N, float scale,
                   cudaStream_t stream) {
  constexpr int ROWS = Split<DH>::ROWS;
  const int n_blocks = (N + ROWS - 1) / ROWS;
  const long long ctas = (long long)B * H * n_blocks;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_attn_bwd_dq_kernel<DH><<<(unsigned)ctas, kThreads, 0, stream>>>(
      q, k, v, plan, o, lse, dout, dq, delta, H, N, scale, n_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // same stream: pass 2 reads the D that pass 1 wrote
  flash_attn_bwd_dkdv_kernel<DH><<<(unsigned)ctas, kThreads, 0, stream>>>(
      q, k, v, plan, lse, dout, delta, dk, dv, H, N, scale, n_blocks);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous, 16-byte aligned arrays: q, k, v, o, dout, dq, dk, dv
// [B, H, N, dh] and lse, delta (scratch for D) [B, H, N] float32; the
// plan's key_perm, row_perm [B, N] and n_ctx, n_vis, n_query, dense [B]
// int32 (flash_plan.cu).  Returns the cudaError_t of the launches (0 =
// launched).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* key_perm, const void* row_perm,
                              const void* n_ctx, const void* n_vis,
                              const void* n_query, const void* dense,
                              const void* o, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int B, int H, int N, int dh,
                              float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const Plan plan{static_cast<const int*>(key_perm),
                  static_cast<const int*>(row_perm),
                  static_cast<const int*>(n_ctx), static_cast<const int*>(n_vis),
                  static_cast<const int*>(n_query),
                  static_cast<const int*>(dense)};
  const float* of = static_cast<const float*>(o);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8: return launch<8>(qf, kf, vf, plan, of, lf, gf, dqf, dkf, dvf, df, B, H, N, scale, s);
    case 16: return launch<16>(qf, kf, vf, plan, of, lf, gf, dqf, dkf, dvf, df, B, H, N, scale, s);
    case 32: return launch<32>(qf, kf, vf, plan, of, lf, gf, dqf, dkf, dvf, df, B, H, N, scale, s);
    case 64: return launch<64>(qf, kf, vf, plan, of, lf, gf, dqf, dkf, dvf, df, B, H, N, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
