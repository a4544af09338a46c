// The EIG fold of location finding for Hopper (sm_90a), float32.
//
// Replaces no Pallas kernel.  It stands where XLA fuses
// aline_tpu/eval/eig.py _accumulate_chunks (:79): one chunk of Lc
// contrastive draws folded into the running logsumexp of the sPCE/sNMC
// bounds (aline_tpu_torch/eval/eig.py).  For every draw l of the chunk,
// row b and step t it computes
//
//     mu    = log(base + sum_k 1 / (max_signal + |x_bt - theta_lbk|^2))
//     ll    = -0.5 ((y_bt - mu) / noise)^2 - 0.5 log(2 pi) - log(noise)
//     S_lbt = sum_{s <= t} ll_lbs
//
// and folds S over l into the (max, sumexp) state of each (b, t), as
// parallel/collectives.py lse_update does; draws from n_valid on (the
// padding past L) add nothing.  In plain PyTorch the fold wrote [Lc, B,
// Th] and [Lc, B, Th, K, D] blocks to device memory at every step of the
// formula, ran a cumulative sum along the 35-element axis and three more
// passes for the logsumexp.  Here no such block exists: a term needs one
// theta (K*D floats, the same for every t), one design and one outcome
// (the same for every l), and the running sum over t is one register.
//
// What bounds it.  Per term K reciprocals, a log and an exp: K + 2
// special-function results (portbench/counts/eig_fold.py).  At the BED
// cell's shape (L = 1e6, B = 200, Th = 35, K = 1, D = 2: 7e9 terms a
// batch) at 4.18e12 results a second that is 5.02 ms a batch, 0.048 ms a
// chunk of 9,586 draws; the bytes (the draws, x, y and the [B, Th]
// state) are a few MB a chunk.  The accurate logf, expf and IEEE
// division are FMA-pipe sequences around one MUFU instruction each: the
// step loop issues about 94 instructions a term on sm_90a (logf 27, the
// two divisions 22 with their range checks, expf 14), so the issue rate,
// 4 instructions a clock an SM, bounds this kernel near 0.19 ms a chunk,
// 20 ms a batch.  The design spends nothing beyond the formula: no term
// is written, each theta is read once, and the logsumexp takes one exp a
// term.
//
// Design.
//  * A block of kThreads threads takes row b and kBlockDraws draws: thread
//    tid owns draws g * kBlockDraws + j * kThreads + tid, j < kDraws, and
//    keeps their thetas and running sums S_j in registers (thetas in
//    registers at K = 1, D = 2, the shape of every configuration of the
//    task; other shapes read them through L1).  It walks t = 0 .. Th - 1, all threads of the block at
//    the same t, so x_bt and y_bt are broadcast loads.
//  * The streaming logsumexp over the draws is eig_fold_reduce.cuh's,
//    shared with the CES fold: at each t each thread's (max, sumexp) of
//    its kDraws sums goes to one slot per (t, thread) of a shared tile of
//    at most kTileMax steps (Th runs in tiles of equal size, so any Th
//    fits; the slots cost 1 KB a step); after each tile one warp per step
//    combines the block's 128 slots in a fixed order into the block's
//    partial (m, s) for (g, b, t); a second kernel combines the partials
//    over g in order and merges them into the state as lse_update does.
//    An empty side (max = -inf) adds exactly 0, so a chunk with no valid
//    draw leaves the state bit for bit.
//  * Every sum runs in a fixed order and no float is added atomically:
//    the same inputs give the same bits on every call, and as each chunk
//    is one call of the same shape, any grouping of the chunks into
//    calls gives the same bounds (tests/test_torch_eig.py).
//  * The grid covers only the valid draws (ceil(n_valid / kBlockDraws)
//    blocks a row), so the last chunk's padding costs nothing.
//
// tests/test_torch_eig_fold.py emulates this order in PyTorch on the CPU
// (and reads kThreads, kDraws and kTileMax from this file); tests/
// test_torch_cuda.py holds the kernel to its plain version on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eig_fold_reduce.cuh"

namespace {

constexpr int kThreads = 128;                 // a block's threads
constexpr int kDraws = 4;                     // draws a thread folds
constexpr int kBlockDraws = kThreads * kDraws;
constexpr int kTileMax = 32;                  // steps of a shared tile
constexpr float kLog2Pi = 1.8378770664093453f;

// log p(y | x, theta) of one term; theta is th[k * D + d], the design
// xt[d]
template <int KC, int DC>
__device__ __forceinline__ float loglik(const float* th, const float* xt,
                                        float yt, int K, int D, float base,
                                        float max_signal, float noise,
                                        float log_noise) {
  const int KK = KC > 0 ? KC : K;
  const int DD = DC > 0 ? DC : D;
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    float sq = 0.0f;
#pragma unroll
    for (int d = 0; d < DD; ++d) {
      const float diff = xt[d] - th[k * DD + d];
      sq = fmaf(diff, diff, sq);
    }
    total += 1.0f / (max_signal + sq);
  }
  const float z = (yt - logf(base + total)) / noise;
  return -0.5f * (z * z + kLog2Pi) - log_noise;
}

// Each block's partial (max, sumexp) of every step, [G, B, Th]
template <int KC, int DC>
__global__ void __launch_bounds__(kThreads)
    fold_partials(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ thetas, float2* __restrict__ part,
                  long long n_valid, int B, int Th, int K, int D, int tile,
                  float base, float max_signal, float noise,
                  float log_noise) {
  extern __shared__ float2 slots[];            // [tile][kThreads]
  constexpr int KD = KC > 0 && DC > 0 ? KC * DC : 1;
  const int b = blockIdx.x % B;
  const long long g = blockIdx.x / B;
  const int tid = threadIdx.x;
  const int kd = K * D;
  const float* xb = x + (long long)b * Th * D;
  const float* yb = y + (long long)b * Th;

  const float* thp[kDraws];
  float th[kDraws][KD];
  float S[kDraws];
  int nj = 0;                                  // valid draws: a prefix of j
#pragma unroll
  for (int j = 0; j < kDraws; ++j) {
    const long long l = g * kBlockDraws + (long long)j * kThreads + tid;
    const bool valid = l < n_valid;
    nj += valid;
    thp[j] = thetas + ((valid ? l : 0) * B + b) * kd;
    S[j] = 0.0f;
#pragma unroll
    for (int e = 0; e < KD; ++e)
      th[j][e] = KC > 0 && valid ? __ldg(thp[j] + e) : 0.0f;
  }

  for (int t0 = 0; t0 < Th; t0 += tile) {
    const int nt = min(tile, Th - t0);
    for (int i = 0; i < nt; ++i) {
      const int t = t0 + i;
      const float yt = __ldg(yb + t);
      float xr[DC > 0 ? DC : 1];
#pragma unroll
      for (int d = 0; d < DC; ++d) xr[d] = __ldg(xb + t * D + d);
#pragma unroll
      for (int j = 0; j < kDraws; ++j) {
        if (j < nj) {
          if constexpr (KC > 0) {
            S[j] += loglik<KC, DC>(th[j], xr, yt, K, D, base, max_signal,
                                   noise, log_noise);
          } else {
            S[j] += loglik<0, 0>(thp[j], xb + t * D, yt, K, D, base,
                                 max_signal, noise, log_noise);
          }
        }
      }
      slots[i * kThreads + tid] = eig_fold::thread_pair(S, nj);
    }
    __syncthreads();
    eig_fold::tile_partials<kThreads>(slots, nt, part + (g * B + b) * Th + t0);
    __syncthreads();
  }
}

template <int KC, int DC>
cudaError_t launch_partials(dim3 grid, size_t smem, cudaStream_t s,
                            const float* x, const float* y, const float* th,
                            float2* part, long long n_valid, int B, int Th,
                            int K, int D, int tile, float base,
                            float max_signal, float noise, float log_noise) {
  fold_partials<KC, DC><<<grid, kThreads, smem, s>>>(
      x, y, th, part, n_valid, B, Th, K, D, tile, base, max_signal, noise,
      log_noise);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch (the blocks' partials) a call with n_valid valid
// draws, B rows and Th steps needs.
extern "C" long long loc_eig_fold_scratch(long long n_valid, int B, int Th) {
  return 2 * eig_fold::n_groups(n_valid, kBlockDraws) * B * Th;
}

// One chunk folded into the state: x [B, Th, D] designs (real space), y
// [B, Th] outcomes, thetas [>= n_valid, B, K, D], the state's max and
// sumexp [B, Th] in, the new state out; all float32, contiguous.
extern "C" int loc_eig_fold(const void* x, const void* y, const void* thetas,
                            const void* max_in, const void* sumexp_in,
                            void* max_out, void* sumexp_out, void* scratch,
                            long long n_valid, int B, int Th, int K, int D,
                            float base_signal, float max_signal,
                            float noise_scale, void* stream) {
  if (B <= 0 || Th <= 0) return 0;
  if (K <= 0 || D <= 0 || n_valid < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long G = eig_fold::n_groups(n_valid, kBlockDraws);
  const long long n = (long long)B * Th;
  float2* part = static_cast<float2*>(scratch);
  // -log(noise) as the plain version takes it: the double log rounded
  const float log_noise = (float)log((double)noise_scale);
  if (G > 0) {
    if (G * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int tile = eig_fold::tile_steps(Th, kTileMax);
    const size_t smem = (size_t)tile * kThreads * sizeof(float2);
    const dim3 grid((unsigned)(G * B));
    const float* xf = static_cast<const float*>(x);
    const float* yf = static_cast<const float*>(y);
    const float* tf = static_cast<const float*>(thetas);
    const cudaError_t err =
        K == 1 && D == 2
            ? launch_partials<1, 2>(grid, smem, s, xf, yf, tf, part, n_valid,
                                    B, Th, K, D, tile, base_signal,
                                    max_signal, noise_scale, log_noise)
            : launch_partials<0, 0>(grid, smem, s, xf, yf, tf, part, n_valid,
                                    B, Th, K, D, tile, base_signal,
                                    max_signal, noise_scale, log_noise);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)eig_fold::launch_merge(
      part, G, n, static_cast<const float*>(max_in),
      static_cast<const float*>(sumexp_in), static_cast<float*>(max_out),
      static_cast<float*>(sumexp_out), s);
}
