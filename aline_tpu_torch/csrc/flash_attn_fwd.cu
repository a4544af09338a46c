// Role-masked flash-attention forward for Hopper (sm_90a), float32 and
// bfloat16.
//
// Replaces the Pallas TPU kernel aline_tpu/ops/flash_attention.py:43
// (_fwd_kernel, entered through flash_role_attention and _flash_fwd).  For
// q, k, v [B, H, N, dh] and the role codes kcode, qrow [B, N] it computes,
// per (b, h) and query row i,
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
// Only the pairs the mask allows are scored.  The kernel walks the mask's
// plan (flash_plan.cu): a query row the first n_vis keys of key_perm (codes
// 1 and 2), any other row the first n_ctx (code 1).  A masked score is
// replaced by -1e9, so for a row that sees some key each skipped column
// adds exp(-1e9 - m) = 0 in float32: skipping changes only the order of the
// sums.  In a batch row where some row sees no key (plan.dense) every row
// walks all N keys, which keeps the Np average of the TPU kernel.
//
// What bounds it.  At the eval shape (B=100, H=4, N=2103, dh=8) the mask
// allows 5.4% of the pairs: 4·dh FLOP a pair is 3 GFLOP, 0.045 ms at the
// 67 TFLOP/s of float32 outside the tensor cores, against 0.034 ms for the
// 113 MB of q, k, v, O, lse and the codes.  Each pair also takes an exp and the online
// softmax's compares, so the rate of instructions, and not memory, bounds
// the kernel.  The design keeps that work per pair small:
//  * One CTA of 128 threads per (b, h, block of rows), the rows taken in
//    row_perm order, so a warp's rows share one walk length (query rows
//    first).  A row is owned by a group of G = dh/16 lanes (G = 1 for
//    dh <= 16), each with DPT = dh/G of its q and accumulator dims in
//    registers; a score is the group's partial dots summed by xor-shuffles.
//  * The keys of key_perm are gathered into a two-stage shared-memory ring
//    by 16-byte cp.async copies: the next tile is in flight while the
//    current one is scored.  A key's code follows from its position in
//    key_perm, so kcode is not read.  All groups of a warp read the same
//    key row, so shared reads are broadcasts.
//  * Online softmax in chunks of keys: the chunk's scores stay in
//    registers, the running max moves once per chunk, and the accumulator
//    and the row sum are rescaled once per chunk.
//  * The score comes from masked_score (flash_attn_common.cuh), which the
//    backward's passes call too.
//
// bfloat16 (flash_attn_fwd_bf16) has a kernel of its own,
// flash_attn_fwd_bf16_kernel, on the bf16 tensor cores (building blocks in
// flash_attn_mma.cuh).  It computes what the TPU kernel computes with
// bfloat16 q, k, v: float32 scores of the bfloat16 operands, a float32
// online softmax and lse, P·V in float32, O rounded once.
//
// What bounds it.  At the eval shape the mask allows 9.5e7 (row, key)
// pairs.  Each takes one exp: 0.023 ms at the 4.18e12 exp/s of the
// special-function units (16 a clock on each of 132 SMs at 1.98 GHz),
// above the 0.018 ms of its 59 MB (2 bytes an element of q, k, v, O) and
// far above the products' 0.006 ms on the tensor cores (q·kᵀ once, P·V
// as three bfloat16 products).  So the instructions a pair takes bound it,
// and the float32 form above (one row a lane) spends about 35 a pair on
// the CUDA cores.  The design moves the products to the tensor cores and
// keeps the rest per pair small:
//  * A warp owns 16 consecutive rows of row_perm, a CTA 4 warps.  The keys
//    of key_perm are gathered into a two-stage shared ring of 64-key
//    tiles by 16-byte cp.async (zeros past N), read by ldmatrix; the
//    first tile is in flight before the plan's counts are read.
//  * S = Q Kᵀ by mma.sync (m16n8k8 at dh = 8, m16n8k16 over dh / 16 steps
//    above), float32 sums of exact bfloat16 products, in chunks of 16
//    keys; a warp walks its first row's keys rounded up to 16.  A chunk
//    inside the codes every row of the warp sees (code 1, or codes 1 and 2
//    for a warp of query rows) takes no mask; the others score each pair
//    by the codes (walk_score).
//  * Online softmax on the accumulator fragments in log2 units (the scale
//    times log2 e, ex2): a row's max and sum over its quad by two
//    shuffles, one rescale a 64-key stage, the sum reduced once at the end.
//  * P·V as three bfloat16 pieces of P (split3) on m16n8k16 into float32:
//    P stays in registers.
// By count of the operations above, a pair costs a thread about 12
// instructions (a warp's 100 or so for 16 rows x 16 keys, 8 of them
// exps), where the float32 form spends about 35.  At the eval shape the
// kernel takes well over that count's issue time: the CTAs' gathers and
// stores take a large share of it.  Variants that gave a CTA more rows (several 16-row groups a warp, or
// 64-row blocks in turn over a resident ring), capped the registers, or
// summed the three pieces into separate accumulators measured no faster.

#include <cuda_runtime.h>
#include <limits.h>

#include <type_traits>

#include "flash_attn_common.cuh"
#include "flash_attn_mma.cuh"

namespace {

using namespace flash;

// O_i = acc / l over a lane's dims, stored as T
template <int DPT>
__device__ __forceinline__ void store_out(float* dst, const float* acc,
                                          float l) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int d4 = 0; d4 < DPT / 4; ++d4)
    d[d4] = make_float4(acc[4 * d4 + 0] / l, acc[4 * d4 + 1] / l,
                        acc[4 * d4 + 2] / l, acc[4 * d4 + 3] / l);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const Plan plan,
                      T* __restrict__ o, float* __restrict__ lse, int H,
                      int N, int n_pad, float scale, int n_blocks) {
  constexpr int DPT = Split<DH>::DPT, G = Split<DH>::G;
  constexpr int ROWS = Split<DH>::ROWS, TILE = Split<DH>::TILE;
  constexpr int kChunk = DH <= 16 ? 16 : 8;
  T* const ring = dyn_smem<T>();           // fwd_smem<DH, T>() bytes
  const Ring<T> ks{ring, TILE * DH};
  const Ring<T> vs{ring + 2 * TILE * DH, TILE * DH};

  const int bh = blockIdx.x / n_blocks;
  const PlanRow pr = plan_row(plan, bh / H, N);
  const int r0 = (blockIdx.x % n_blocks) * ROWS;   // positions in row_perm
  const int part = threadIdx.x % G;
  const int r = r0 + threadIdx.x / G;
  const bool live = r < N;
  const int i = live ? pr.row_perm[r] : 0;
  const size_t head = (size_t)bh * N * DH;          // (b, h) in q, k, v, o
  const T* kh = k + head;
  const T* vh = v + head;

  float qr[DPT], acc[DPT];
  load_dims<DPT>(qr, q + head + (size_t)i * DH + part * DPT, live);
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  const bool is_query = r < pr.n_query;
  float m = kNeg, l = 0.f;  // every score is >= -1e9, so m starts there

  // the CTA walks as far as its first row, a warp as far as its own first
  const int n_keys = pr.keys_for(r0);
  const int warp_keys = pr.keys_for(r0 + (threadIdx.x / 32) * (32 / G));
  const int n_tiles = (n_keys + TILE - 1) / TILE;
  if (n_tiles > 0)
    gather_rows<DH>(ks[0], vs[0], kh, vh, pr.key_perm, 0, min(TILE, n_keys));
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * TILE;
    if (t + 1 < n_tiles)       // the stage read in step t - 1 is free again
      gather_rows<DH>(ks[(t + 1) & 1], vs[(t + 1) & 1], kh, vh, pr.key_perm,
                      j0 + TILE, min(TILE, n_keys - j0 - TILE));
    cp_async_commit();
    cp_async_wait<1>();                         // tile t has landed
    __syncthreads();
    const T* kt = ks[t & 1] + part * DPT;       // the lane's dims of a row
    const T* vt = vs[t & 1] + part * DPT;
    const int n = min(TILE, warp_keys - j0);    // uniform in the warp
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float s[kChunk];
      float mc = kNeg;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        s[u] = kNeg;
        if (c0 + u < n) {                       // uniform: shuffles are safe
          s[u] = masked_score<DH>(qr, kt + (c0 + u) * DH, scale,
                                  pr.code(j0 + c0 + u), is_query);
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
          axpy_dims<DPT>(acc, p, vt + (c0 + u) * DH);
        }
      }
    }
    __syncthreads();                            // stage t & 1 is consumed
  }
  // the padded columns: score -1e9, v = 0 (adds 0 unless the row is blind)
  l += (float)n_pad * expf(kNeg - m);
  if (!live) return;
  store_out<DPT>(o + head + (size_t)i * DH + part * DPT, acc, l);
  if (part == 0) lse[(size_t)bh * N + i] = m + logf(l);
}

// The bfloat16 form on the tensor cores (see the note at the top).

// A warp's 16 rows: their q fragments, O accumulators, running max and
// sum; this thread holds rows g and g + 8.
template <int DH>
struct RowGroup {
  using S = mma::Shape<DH>;
  int rpos[2];                 // positions in row_perm
  int row[2];                  // row indices; -1: past N
  uint32_t qf[S::KS][4];
  float acc[S::NT][4];
  float m[2], l[2];            // log2 units; every score is >= kNeg2
  int keys;                    // keys walked (a multiple of 16)
  bool all_query;              // every row of the group is a query row

  // the rows of row_perm [w0, w0 + 16) and their q
  __device__ __forceinline__ void init(const PlanRow& pr, const bf16* qh,
                                       int w0, int lane) {
    using namespace mma;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rpos[h] = w0 + lane / 4 + 8 * h;
      row[h] = rpos[h] < pr.N ? pr.row_perm[rpos[h]] : -1;
      m[h] = kNeg2;
      l[h] = 0.f;
    }
    load_a<DH>(qf, qh, row, lane % 4);
    mma::zero(acc);
    keys = ceil16(pr.keys_for(w0));
    all_query = w0 + 16 <= pr.n_query;
  }

  // the keys of key_perm [j0, j0 + kTile) from the stage ks, vs
  __device__ __forceinline__ void step(const PlanRow& pr, const bf16* ks,
                                       const bf16* vs, int j0, float c2,
                                       int lane) {
    using namespace mma;
    const int n = keys - j0, tq = lane % 4;   // uniform in the warp
    if (n <= 0) return;
    float s[kChunks][2][4];
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (16 * c >= n) continue;
      mma_nt<DH>(s[c], qf, ks, 16 * c, lane);
      const int p0 = j0 + 16 * c;             // the chunk's first key
      if (p0 + 16 <= pr.n_ctx || (all_query && p0 + 16 <= pr.n_vis)) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)        // every pair allowed
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][nt][e] *= c2;
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = p0 + 8 * nt + 2 * tq + (e & 1);
            s[c][nt][e] = walk_score(s[c][nt][e], c2, p < pr.N,
                                     pr.allows(rpos[e >> 1], p));
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h] = fmaxf(mx[h], fmaxf(fmaxf(s[c][0][2 * h], s[c][0][2 * h + 1]),
                                   fmaxf(s[c][1][2 * h], s[c][1][2 * h + 1])));
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int u = 0; u < S::NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] *= alpha[e >> 1];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (16 * c >= n) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[c][nt][e] = ex2(s[c][nt][e] - m[e >> 1]);
          l[e >> 1] += s[c][nt][e];
        }
      uint32_t w[3][4];
      split3(w, s[c]);
      mma_split_t<DH>(acc, w, vs, 16 * c, lane);
    }
  }

  // O and lse of the group's rows; n_pad padded columns score -1e9 and
  // have v = 0 (they add 0 unless a row is blind)
  __device__ __forceinline__ void finish(bf16* oh, float* lseh, int n_pad,
                                         int lane) {
    using namespace mma;
    const int tq = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = group_sum<4>(l[h]) + (float)n_pad * ex2(kNeg2 - m[h]);
      // a blind row's max is the replaced score itself: its lse is -1e9 +
      // log(Np) as the TPU kernel's, not a log2 round trip of -1e9
      if (row[h] >= 0 && tq == 0)
        lseh[row[h]] =
            m[h] == kNeg2 ? kNeg + logf(l[h]) : m[h] * kLn2 + logf(l[h]);
    }
#pragma unroll
    for (int u = 0; u < S::NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] /= l[e >> 1];
    const float one[2] = {1.f, 1.f};
    store_rows<DH>(oh, acc, row, 2 * tq, one);
  }
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const Plan plan,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int H, int N, int n_pad, float scale,
                           int n_blocks) {
  using namespace mma;
  using S = Shape<DH>;
  bf16* const ring = dyn_smem<bf16>();     // fwd_smem<DH, bf16>() bytes
  const Ring<bf16> ks{ring, kTile * S::SROW};
  const Ring<bf16> vs{ring + 2 * kTile * S::SROW,
                      kTile * S::SROW};

  const int bh = blockIdx.x / n_blocks;
  const PlanRow pr = plan_row(plan, bh / H, N);
  const int r0 = (blockIdx.x % n_blocks) * kRows;    // positions in row_perm
  const int lane = threadIdx.x % 32;
  const size_t head = (size_t)bh * N * DH;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const float c2 = scale * kLog2e;

  // the first stage is in flight before the plan's counts arrive
  gather_tiles<DH>(ks[0], vs[0], kh, vh, pr.key_perm, 0,
                   min(kTile, ceil16(N)), N);
  cp_async_commit();
  RowGroup<DH> rows;
  rows.init(pr, q + head, r0 + 16 * (threadIdx.x / 32), lane);
  // the CTA walks as far as its first row, a warp as far as its own first
  const int n_keys = ceil16(pr.keys_for(r0));
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    if (t + 1 < n_tiles)       // the stage read in step t - 1 is free again
      gather_tiles<DH>(ks[(t + 1) & 1], vs[(t + 1) & 1], kh, vh,
                       pr.key_perm, j0 + kTile,
                       min(kTile, n_keys - j0 - kTile), N);
    cp_async_commit();
    cp_async_wait<1>();                         // tile t has landed
    __syncthreads();
    rows.step(pr, ks[t & 1], vs[t & 1], j0, c2, lane);
    __syncthreads();                            // stage t & 1 is consumed
  }
  cp_async_wait<0>();          // no copy outlives the CTA (n_tiles = 0)
  rows.finish(o + head, lse + (size_t)bh * N, n_pad, lane);
}

// the dynamic shared memory of a forward CTA: two stages of k and v tiles
template <int DH, typename T>
constexpr size_t fwd_smem() {
  if constexpr (std::is_same<T, bf16>::value)
    return 4 * (size_t)mma::Shape<DH>::STAGE_BYTES;
  else
    return 4 * (size_t)Split<DH>::TILE * DH * sizeof(T);
}

template <int DH, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const Plan& plan,
                   T* o, float* lse, int B, int H, int N, int n_pad,
                   float scale, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int ROWS = kBf16 ? mma::kRows : Split<DH>::ROWS;
  constexpr size_t smem = fwd_smem<DH, T>();
  static int granted[kMaxDevices] = {};
  const int n_blocks = (N + ROWS - 1) / ROWS;
  const long long ctas = (long long)B * H * n_blocks;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e;
  if constexpr (kBf16) {
    e = allow_smem((const void*)flash_attn_fwd_bf16_kernel<DH>, smem,
                   granted);
    if (e != cudaSuccess) return e;
    flash_attn_fwd_bf16_kernel<DH><<<(unsigned)ctas, kThreads, smem,
                                     stream>>>(q, k, v, plan, o, lse, H, N,
                                               n_pad, scale, n_blocks);
  } else {
    e = allow_smem((const void*)flash_attn_fwd_kernel<DH, T>, smem, granted);
    if (e != cudaSuccess) return e;
    flash_attn_fwd_kernel<DH, T><<<(unsigned)ctas, kThreads, smem, stream>>>(
        q, k, v, plan, o, lse, H, N, n_pad, scale, n_blocks);
  }
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* key_perm,
        const void* row_perm, const void* n_ctx, const void* n_vis,
        const void* n_query, const void* dense, void* o, void* lse, int B,
        int H, int N, int n_pad, int dh, float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const Plan plan{static_cast<const int*>(key_perm),
                  static_cast<const int*>(row_perm),
                  static_cast<const int*>(n_ctx), static_cast<const int*>(n_vis),
                  static_cast<const int*>(n_query),
                  static_cast<const int*>(dense)};
  T* ot = static_cast<T*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8: return launch<8>(qt, kt, vt, plan, ot, lf, B, H, N, n_pad, scale, s);
    case 16: return launch<16>(qt, kt, vt, plan, ot, lf, B, H, N, n_pad, scale, s);
    case 32: return launch<32>(qt, kt, vt, plan, ot, lf, B, H, N, n_pad, scale, s);
    case 64: return launch<64>(qt, kt, vt, plan, ot, lf, B, H, N, n_pad, scale, s);
    case 128: return launch<128>(qt, kt, vt, plan, ot, lf, B, H, N, n_pad, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous, 16-byte aligned arrays: q, k, v, o [B, H, N, dh] (float32 in
// flash_attn_fwd, bfloat16 in flash_attn_fwd_bf16) and lse [B, H, N]
// float32; the plan's key_perm, row_perm [B, N] and n_ctx, n_vis,
// n_query, dense [B] int32 (flash_plan.cu).  n_pad = Np - N; dh in {8, 16,
// 32, 64, 128}.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* key_perm, const void* row_perm,
                              const void* n_ctx, const void* n_vis,
                              const void* n_query, const void* dense, void* o,
                              void* lse, int B, int H, int N, int n_pad,
                              int dh, float scale, void* stream) {
  return run<float>(q, k, v, key_perm, row_perm, n_ctx, n_vis, n_query, dense,
                    o, lse, B, H, N, n_pad, dh, scale, stream);
}

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k,
                                   const void* v, const void* key_perm,
                                   const void* row_perm, const void* n_ctx,
                                   const void* n_vis, const void* n_query,
                                   const void* dense, void* o, void* lse,
                                   int B, int H, int N, int n_pad, int dh,
                                   float scale, void* stream) {
  return run<bf16>(q, k, v, key_perm, row_perm, n_ctx, n_vis, n_query, dense,
                   o, lse, B, H, N, n_pad, dh, scale, stream);
}
