// Role-masked flash-attention backward for Hopper (sm_90a), float32 and
// bfloat16.
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

// bfloat16 (flash_attn_bwd_bf16) has kernels of their own on the bf16
// tensor cores, flash_attn_bwd_{dq,dkdv}_bf16_kernel (building blocks in
// flash_attn_mma.cuh), in the same two passes over the same walks.  They
// compute what the TPU kernel computes with bfloat16 operands: scores and
// dP = dO·vᵀ are float32 sums of exact bfloat16 products, P, dS and every
// product with them are float32, dQ, dK and dV are rounded once each where
// they are stored.  D_i, the float32 sum of the products dO_id O_id, is
// summed in the order of the float32 kernel's pass 1 and rounded to
// bfloat16, as the TPU kernel's bfloat16 sum(do * o) is (XLA sums it in
// float32 and rounds once).  The TPU kernel sums dK and dV into bfloat16
// outputs, one rounding per block of bq rows (3 at N = 303, 17 at N =
// 2103); here each column's sums run in float32 over all its rows, so the
// kernel is the more accurate of the two and differs from the TPU's and
// the plain version's per-block sums by those roundings.
//
// What bounds them.  At the training shape the 1.9e7 allowed pairs take
// two exps each (P in each pass): 0.009 ms at 4.18e12 exp/s, beside
// 0.010 ms for the 33 MB moved and 0.003 ms of tensor-core products
// (S and dP in bfloat16, the three P- and dS-products as three bfloat16
// products each).  The float32 form spends some 60 instructions a pair on
// the CUDA cores.  Design, per pass as in the forward (a warp owns 16
// rows or 16 key columns, 64-wide stages gathered by cp.async, chunks of
// 16 outside the codes every row of the warp sees masked by walk_score):
//  * pass 1: S = Q Kᵀ and dP = dO Vᵀ by mma.sync, P = exp2(S - lse·log2 e),
//    dS = P (dP - D), dQ += dS K as three bfloat16 pieces of dS on
//    m16n8k16 (K read transposed by ldmatrix);
//  * pass 2: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, dV += Pᵀ dO and dK += dSᵀ Q, each
//    as three pieces.
// Pass 1 computes S with the forward's instructions on the same operands,
// so its scores are the forward's bit for bit; pass 2 takes the same
// products over the same k positions in the transposed orientation, and
// its P may differ from pass 1's in the last bits of the tensor cores'
// sums.  At dh = 128 a pass-2 warp's k and v fragments and two [16, 128]
// float32 accumulators would need more than a thread's 255 registers, so
// two warps take the same 16 key columns, each computing Sᵀ and dPᵀ whole
// and summing dK and dV over one half of dh (Shape::WAYS): the scores cost
// twice, the accumulators half.  By count, a pair costs a thread about 12 instructions in pass 1
// and 19 in pass 2.  At the training shape the keys that pass 2 walks
// (codes 1 and 2) fill two of a head's five CTAs, so few CTAs carry that
// pass.  No atomics: bitwise repeatable.

#include <cuda_runtime.h>
#include <limits.h>

#include <type_traits>

#include "flash_attn_common.cuh"
#include "flash_attn_mma.cuh"

namespace {

using namespace flash;

// Pass 1: dQ and D, one thread group per row.
template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const Plan plan,
                         const T* __restrict__ o,
                         const float* __restrict__ lse,
                         const T* __restrict__ dout, T* __restrict__ dq,
                         float* __restrict__ delta, int H, int N,
                         float scale, int n_blocks) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  constexpr int ROWS = Split<DH>::ROWS, TILE = Split<DH>::TILE;
  T* const ring = dyn_smem<T>();           // ring_smem<DH, T>() bytes
  const Ring<T> ks{ring, TILE * DH};
  const Ring<T> vs{ring + 2 * TILE * DH, TILE * DH};

  const int bh = blockIdx.x / n_blocks;
  const PlanRow pr = plan_row(plan, bh / H, N);
  const int r0 = (blockIdx.x % n_blocks) * ROWS;   // positions in row_perm
  const int part = threadIdx.x % G;
  const int r = r0 + threadIdx.x / G;
  const bool live = r < N;
  const int i = live ? pr.row_perm[r] : 0;
  const size_t head = (size_t)bh * N * DH;
  const size_t row = head + (size_t)i * DH + part * DPT;
  const T* kh = k + head;
  const T* vh = v + head;

  float qr[DPT], dor[DPT], acc[DPT];
  load_dims<DPT>(qr, q + row, live);
  load_dims<DPT>(dor, dout + row, live);
  load_dims<DPT>(acc, o + row, live);           // O_i, for D_i only
  float d_i = 0.f;
#pragma unroll
  for (int d = 0; d < DPT; ++d) d_i = fmaf(dor[d], acc[d], d_i);
  d_i = rounded<T>(group_sum<G>(d_i));     // as the TPU kernel's sum
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
    const T* kt = ks[t & 1] + part * DPT;       // the lane's dims of a row
    const T* vt = vs[t & 1] + part * DPT;
    const int n = min(TILE, warp_keys - j0);    // uniform in the warp
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const T* kr = kt + j * DH;
      const float s = masked_score<DH>(qr, kr, scale, pr.code(j0 + j),
                                       is_query);
      const float p = expf(s - lse_i);
      const float dp = group_sum<G>(dot_dims<DPT>(dor, vt + j * DH));
      axpy_dims<DPT>(acc, p * (dp - d_i), kr);
    }
    __syncthreads();
  }
  if (live) store_dims<DPT>(dq + row, acc, scale);
}

// Pass 2: dK and dV, one thread group per key column.
template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const Plan plan,
                           const float* __restrict__ lse,
                           const T* __restrict__ dout,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int H,
                           int N, float scale, int n_blocks) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  constexpr int ROWS = Split<DH>::ROWS, TILE = Split<DH>::TILE;
  T* const ring = dyn_smem<T>();           // ring_smem<DH, T>() bytes
  const Ring<T> qs{ring, TILE * DH};
  const Ring<T> dos{ring + 2 * TILE * DH, TILE * DH};
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
  const T* qh = q + head;
  const T* doh = dout + head;
  const float* lseh = lse + (size_t)bh * N;
  const float* deltah = delta + (size_t)bh * N;

  float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
  load_dims<DPT>(kr, k + col, live);
  load_dims<DPT>(vr, v + col, live);
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
    const T* qt = qs[t & 1] + part * DPT;       // the lane's dims of a row
    const T* gt = dos[t & 1] + part * DPT;
    const float* lt = lses[t & 1];
    const float* dt = deltas[t & 1];
    const int n = min(TILE, warp_rows - i0);    // uniform in the warp
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const T* qi = qt + i * DH;
      const T* di = gt + i * DH;
      const float s = masked_score<DH>(kr, qi, scale, kc,
                                       i0 + i < pr.n_query);
      const float pij = expf(s - lt[i]);
      axpy_dims<DPT>(dvr, pij, di);
      const float dp = group_sum<G>(dot_dims<DPT>(vr, di));
      axpy_dims<DPT>(dkr, pij * (dp - dt[i]), qi);
    }
    __syncthreads();
  }
  if (!live) return;
  store_dims<DPT>(dk + col, dkr, scale);
  store_dims<DPT>(dv + col, dvr, 1.f);
}

// Pass 1 in bfloat16 on the tensor cores: dQ and D, a warp per 16 rows.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const Plan plan,
                              const bf16* __restrict__ o,
                              const float* __restrict__ lse,
                              const bf16* __restrict__ dout,
                              bf16* __restrict__ dq,
                              float* __restrict__ delta, int H, int N,
                              float scale, int n_blocks) {
  using namespace mma;
  using S = Shape<DH>;
  bf16* const ring = dyn_smem<bf16>();     // ring_smem<DH, bf16>() bytes
  const Ring<bf16> ks{ring, kTile * S::SROW};
  const Ring<bf16> vs{ring + 2 * kTile * S::SROW,
                      kTile * S::SROW};
  __shared__ float d_rows[kWarps][16];

  const int bh = blockIdx.x / n_blocks;
  const PlanRow pr = plan_row(plan, bh / H, N);
  const int r0 = (blockIdx.x % n_blocks) * kRows;    // positions in row_perm
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const int w0 = r0 + 16 * warp;
  const int rpos[2] = {w0 + lane / 4, w0 + lane / 4 + 8};
  int row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) row[h] = rpos[h] < N ? pr.row_perm[rpos[h]] : -1;
  const size_t head = (size_t)bh * N * DH;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  // the first stage is in flight before the plan's counts arrive
  gather_tiles<DH>(ks[0], vs[0], kh, vh, pr.key_perm, 0,
                   min(kTile, ceil16(N)), N);
  cp_async_commit();

  // D of the warp's 16 rows, summed as flash_attn_bwd_dq_kernel sums it: a
  // group of G lanes a row, DPT dims a lane in order, then the group's
  // xor-shuffle tree; rounded to bfloat16
  {
    constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
#pragma unroll
    for (int r = 0; r < 16; r += 32 / G) {
      const int rr = (r + lane / G) % 16, part = lane % G;
      const bool live = w0 + rr < N;
      const int i = live ? pr.row_perm[w0 + rr] : 0;
      const size_t at = head + (size_t)i * DH + part * DPT;
      float dor[DPT], orr[DPT];
      load_dims<DPT>(dor, dout + at, live);
      load_dims<DPT>(orr, o + at, live);
      float d_i = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) d_i = fmaf(dor[d], orr[d], d_i);
      d_i = rounded<bf16>(group_sum<G>(d_i));
      if (part == 0 && r + lane / G < 16) {
        d_rows[warp][rr] = d_i;
        if (live) delta[(size_t)bh * N + i] = d_i;
      }
    }
    __syncwarp();
  }
  float d_row[2], lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    d_row[h] = d_rows[warp][lane / 4 + 8 * h];
    lse2[h] = row[h] < 0 ? 0.f
                         : __fmul_rn(lse[(size_t)bh * N + row[h]], kLog2e);
  }
  uint32_t qf[S::KS][4], df[S::KS][4];
  load_a<DH>(qf, q + head, row, tq);
  load_a<DH>(df, dout + head, row, tq);
  float acc[S::NT][4];
  zero(acc);
  const float c2 = scale * kLog2e;
  const bool all_query = w0 + 16 <= pr.n_query;

  const int n_keys = ceil16(pr.keys_for(r0));
  const int warp_keys = ceil16(pr.keys_for(w0));
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    if (t + 1 < n_tiles)
      gather_tiles<DH>(ks[(t + 1) & 1], vs[(t + 1) & 1], kh, vh,
                       pr.key_perm, j0 + kTile,
                       min(kTile, n_keys - j0 - kTile), N);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int n = warp_keys - j0;               // uniform in the warp
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (16 * c >= n) continue;
      float p[2][4], ds[2][4];
      mma_nt<DH>(p, qf, ks[t & 1], 16 * c, lane);
      mma_nt<DH>(ds, df, vs[t & 1], 16 * c, lane);
      const int p0 = j0 + 16 * c;
      if (p0 + 16 <= pr.n_ctx || (all_query && p0 + 16 <= pr.n_vis)) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)        // every pair allowed
#pragma unroll
          for (int e = 0; e < 4; ++e) p[nt][e] *= c2;
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = p0 + 8 * nt + 2 * tq + (e & 1);
            p[nt][e] = walk_score(p[nt][e], c2, j < N,
                                  pr.allows(rpos[e >> 1], j));
          }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[nt][e] = ex2(p[nt][e] - lse2[e >> 1]);
          ds[nt][e] = p[nt][e] * (ds[nt][e] - d_row[e >> 1]);
        }
      uint32_t w[3][4];
      split3(w, ds);
      mma_split_t<DH>(acc, w, ks[t & 1], 16 * c, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();          // no copy outlives the CTA (n_tiles = 0)
  const float mul[2] = {scale, scale};
  store_rows<DH>(dq + head, acc, row, 2 * tq, mul);
}

// Pass 2 in bfloat16 on the tensor cores: dK and dV, S::WAYS warps per 16
// key columns (each summing NTW of the n8 tiles of dh).
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const Plan plan,
                                const float* __restrict__ lse,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int H, int N, float scale, int n_blocks) {
  using namespace mma;
  using S = Shape<DH>;
  constexpr int NTW = S::NTW;
  bf16* const ring = dyn_smem<bf16>();     // ring_smem<DH, bf16>() bytes
  const Ring<bf16> qs{ring, kTile * S::SROW};
  const Ring<bf16> dos{ring + 2 * kTile * S::SROW,
                       kTile * S::SROW};
  __shared__ __align__(16) float lses[2][kTile];
  __shared__ __align__(16) float deltas[2][kTile];

  const int bh = blockIdx.x / n_blocks;
  const PlanRow pr = plan_row(plan, bh / H, N);
  // positions in key_perm
  const int p0 = (blockIdx.x % n_blocks) * (kRows / S::WAYS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const int w0 = p0 + 16 * (warp / S::WAYS);         // the warp's first key
  const int u0 = NTW * (warp % S::WAYS);             // its first n8 tile
  const int kpos[2] = {w0 + lane / 4, w0 + lane / 4 + 8};
  int col[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) col[h] = kpos[h] < N ? pr.key_perm[kpos[h]] : -1;
  const size_t head = (size_t)bh * N * DH;
  const bf16* qh = q + head;
  const bf16* doh = dout + head;
  const float* lseh = lse + (size_t)bh * N;
  const float* deltah = delta + (size_t)bh * N;

  uint32_t kf[S::KS][4], vf[S::KS][4];
  load_a<DH>(kf, k + head, col, tq);
  load_a<DH>(vf, v + head, col, tq);
  float dka[NTW][4], dva[NTW][4];
  zero(dka);
  zero(dva);
  const float c2 = scale * kLog2e;
  const bool all_ctx = w0 + 16 <= pr.n_ctx;   // every row sees every key
  const bool all_vis = w0 + 16 <= pr.n_vis;   // every query row does

  // rows of row_perm [i0, i0 + n) with their lse and D (zeros past N)
  auto gather = [&](int stage, int i0, int n) {
    gather_tiles<DH>(qs[stage], dos[stage], qh, doh, pr.row_perm, i0, n, N);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const bool ok = i0 + t < N;
      const int i = ok ? pr.row_perm[i0 + t] : 0;
      cp_async4_zfill(&lses[stage][t], lseh + i, ok);
      cp_async4_zfill(&deltas[stage][t], deltah + i, ok);
    }
  };
  // the first stage is in flight before the plan's counts arrive; then
  // the CTA walks as far as its first column, a warp as far as its own
  gather(0, 0, min(kTile, ceil16(N)));
  cp_async_commit();
  const int n_rows = ceil16(pr.rows_for(p0));
  const int warp_rows = ceil16(pr.rows_for(w0));
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * kTile;
    if (t + 1 < n_tiles)
      gather((t + 1) & 1, i0 + kTile, min(kTile, n_rows - i0 - kTile));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int n = warp_rows - i0;               // uniform in the warp
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (16 * c >= n) continue;
      float p[2][4], ds[2][4];                  // Pᵀ and dSᵀ: keys x rows
      mma_nt<DH>(p, kf, qs[t & 1], 16 * c, lane);
      mma_nt<DH>(ds, vf, dos[t & 1], 16 * c, lane);
      const int ic = i0 + 16 * c;               // the chunk's first row
      if (ic + 16 <= N &&
          (all_ctx || (all_vis && ic + 16 <= pr.n_query))) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)        // every pair allowed
#pragma unroll
          for (int e = 0; e < 4; ++e) p[nt][e] *= c2;
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = ic + 8 * nt + 2 * tq + (e & 1), j = kpos[e >> 1];
            p[nt][e] = walk_score(p[nt][e], c2, i < N && j < N,
                                  pr.allows(i, j));
          }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int at = 16 * c + 8 * nt + 2 * tq;   // this thread's rows
        const float2 lse_i = *reinterpret_cast<const float2*>(
            &lses[t & 1][at]);
        const float2 d_i = *reinterpret_cast<const float2*>(
            &deltas[t & 1][at]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[nt][e] = ex2(p[nt][e] -
                         __fmul_rn(e & 1 ? lse_i.y : lse_i.x, kLog2e));
          ds[nt][e] = p[nt][e] * (ds[nt][e] - (e & 1 ? d_i.y : d_i.x));
        }
      }
      uint32_t w[3][4];
      split3(w, p);
      mma_split_t<DH, NTW>(dva, w, dos[t & 1], 16 * c, lane, u0);
      split3(w, ds);
      mma_split_t<DH, NTW>(dka, w, qs[t & 1], 16 * c, lane, u0);
    }
    __syncthreads();
  }
  cp_async_wait<0>();          // no copy outlives the CTA (n_tiles = 0)
  const float kmul[2] = {scale, scale}, vmul[2] = {1.f, 1.f};
  store_rows<DH, NTW>(dk + head, dka, col, 2 * tq, kmul, u0);
  store_rows<DH, NTW>(dv + head, dva, col, 2 * tq, vmul, u0);
}

// the dynamic shared memory of a CTA of either pass: two stages of two
// tiles
template <int DH, typename T>
constexpr size_t ring_smem() {
  if constexpr (std::is_same<T, bf16>::value)
    return 4 * (size_t)mma::Shape<DH>::STAGE_BYTES;
  else
    return 4 * (size_t)Split<DH>::TILE * DH * sizeof(T);
}

template <int DH, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const Plan& plan,
                   const T* o, const float* lse, const T* dout, T* dq, T* dk,
                   T* dv, float* delta, int B, int H, int N, float scale,
                   cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // rows of a pass-1 CTA, key columns of a pass-2 CTA
  constexpr int ROWS = kBf16 ? mma::kRows : Split<DH>::ROWS;
  constexpr int KEYS = kBf16 ? mma::kRows / mma::Shape<DH>::WAYS : ROWS;
  constexpr size_t smem = ring_smem<DH, T>();
  static int granted[2][kMaxDevices] = {};
  const int n_blocks = (N + ROWS - 1) / ROWS;
  const int n_blocks2 = (N + KEYS - 1) / KEYS;
  const long long ctas = (long long)B * H * n_blocks;
  const long long ctas2 = (long long)B * H * n_blocks2;
  if (ctas2 > INT_MAX) return cudaErrorInvalidConfiguration;
  const void* pass1;
  const void* pass2;
  if constexpr (kBf16) {
    pass1 = (const void*)flash_attn_bwd_dq_bf16_kernel<DH>;
    pass2 = (const void*)flash_attn_bwd_dkdv_bf16_kernel<DH>;
  } else {
    pass1 = (const void*)flash_attn_bwd_dq_kernel<DH, T>;
    pass2 = (const void*)flash_attn_bwd_dkdv_kernel<DH, T>;
  }
  cudaError_t e = allow_smem(pass1, smem, granted[0]);
  if (e == cudaSuccess) e = allow_smem(pass2, smem, granted[1]);
  if (e != cudaSuccess) return e;
  if constexpr (kBf16)
    flash_attn_bwd_dq_bf16_kernel<DH>
        <<<(unsigned)ctas, kThreads, smem, stream>>>(
            q, k, v, plan, o, lse, dout, dq, delta, H, N, scale, n_blocks);
  else
    flash_attn_bwd_dq_kernel<DH, T><<<(unsigned)ctas, kThreads, smem,
                                      stream>>>(
        q, k, v, plan, o, lse, dout, dq, delta, H, N, scale, n_blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // same stream: pass 2 reads the D that pass 1 wrote
  if constexpr (kBf16)
    flash_attn_bwd_dkdv_bf16_kernel<DH>
        <<<(unsigned)ctas2, kThreads, smem, stream>>>(
            q, k, v, plan, lse, dout, delta, dk, dv, H, N, scale, n_blocks2);
  else
    flash_attn_bwd_dkdv_kernel<DH, T>
        <<<(unsigned)ctas2, kThreads, smem, stream>>>(
            q, k, v, plan, lse, dout, delta, dk, dv, H, N, scale, n_blocks2);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* key_perm,
        const void* row_perm, const void* n_ctx, const void* n_vis,
        const void* n_query, const void* dense, const void* o,
        const void* lse, const void* dout, void* dq, void* dk, void* dv,
        void* delta, int B, int H, int N, int dh, float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const Plan plan{static_cast<const int*>(key_perm),
                  static_cast<const int*>(row_perm),
                  static_cast<const int*>(n_ctx), static_cast<const int*>(n_vis),
                  static_cast<const int*>(n_query),
                  static_cast<const int*>(dense)};
  const T* ot = static_cast<const T*>(o);
  const float* lf = static_cast<const float*>(lse);
  const T* gt = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8: return launch<8>(qt, kt, vt, plan, ot, lf, gt, dqt, dkt, dvt, df, B, H, N, scale, s);
    case 16: return launch<16>(qt, kt, vt, plan, ot, lf, gt, dqt, dkt, dvt, df, B, H, N, scale, s);
    case 32: return launch<32>(qt, kt, vt, plan, ot, lf, gt, dqt, dkt, dvt, df, B, H, N, scale, s);
    case 64: return launch<64>(qt, kt, vt, plan, ot, lf, gt, dqt, dkt, dvt, df, B, H, N, scale, s);
    case 128: return launch<128>(qt, kt, vt, plan, ot, lf, gt, dqt, dkt, dvt, df, B, H, N, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous, 16-byte aligned arrays: q, k, v, o, dout, dq, dk, dv
// [B, H, N, dh] (float32 in flash_attn_bwd, bfloat16 in
// flash_attn_bwd_bf16) and lse, delta (scratch for D) [B, H, N] float32;
// the plan's key_perm, row_perm [B, N] and n_ctx, n_vis, n_query, dense
// [B] int32 (flash_plan.cu); dh in {8, 16, 32, 64, 128}.  Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* key_perm, const void* row_perm,
                              const void* n_ctx, const void* n_vis,
                              const void* n_query, const void* dense,
                              const void* o, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int B, int H, int N, int dh,
                              float scale, void* stream) {
  return run<float>(q, k, v, key_perm, row_perm, n_ctx, n_vis, n_query, dense,
                    o, lse, dout, dq, dk, dv, delta, B, H, N, dh, scale,
                    stream);
}

extern "C" int flash_attn_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* key_perm,
                                   const void* row_perm, const void* n_ctx,
                                   const void* n_vis, const void* n_query,
                                   const void* dense, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int H, int N, int dh, float scale,
                                   void* stream) {
  return run<bf16>(q, k, v, key_perm, row_perm, n_ctx, n_vis, n_query, dense,
                   o, lse, dout, dq, dk, dv, delta, B, H, N, dh, scale,
                   stream);
}
