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
// bfloat16 (flash_attn_fwd_bf16) is the same kernel with q, k, v and O in
// bfloat16, as the TPU kernel runs with bfloat16 operands: a key row at
// dh = 8 is 16 bytes, one cp.async, and the ring's stages hold bfloat16,
// half the bytes a tile.  An element is widened to float32 as it is read;
// the scores, the online softmax, the accumulator and lse are float32, and
// O is rounded once to bfloat16 where it is stored.

#include <cuda_runtime.h>
#include <limits.h>

#include "flash_attn_common.cuh"

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

template <int DPT>
__device__ __forceinline__ void store_out(bf16* dst, const float* acc,
                                          float l) {
  float out[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) out[d] = acc[d] / l;
  store_dims<DPT>(dst, out, 1.f);
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
  __shared__ __align__(16) T ks[2][TILE * DH];
  __shared__ __align__(16) T vs[2][TILE * DH];

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

template <int DH, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const Plan& plan,
                   T* o, float* lse, int B, int H, int N, int n_pad,
                   float scale, cudaStream_t stream) {
  constexpr int ROWS = Split<DH>::ROWS;
  const int n_blocks = (N + ROWS - 1) / ROWS;
  const long long ctas = (long long)B * H * n_blocks;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_attn_fwd_kernel<DH, T><<<(unsigned)ctas, kThreads, 0, stream>>>(
      q, k, v, plan, o, lse, H, N, n_pad, scale, n_blocks);
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
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous, 16-byte aligned arrays: q, k, v, o [B, H, N, dh] (float32 in
// flash_attn_fwd, bfloat16 in flash_attn_fwd_bf16) and lse [B, H, N]
// float32; the plan's key_perm, row_perm [B, N] and n_ctx, n_vis,
// n_query, dense [B] int32 (flash_plan.cu).  n_pad = Np - N.  Returns the
// cudaError_t of the launch (0 = launched).
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
