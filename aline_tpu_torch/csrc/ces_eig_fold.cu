// The EIG fold of the CES task for Hopper (sm_90a), float32.
//
// Replaces no Pallas kernel.  It stands where XLA fuses
// aline_tpu/eval/eig.py _accumulate_chunks (:79): one chunk of Lc
// contrastive draws folded into the running logsumexp of the sPCE/sNMC
// bounds (aline_tpu_torch/eval/eig.py), for CES with tail_mode "log_ndtr"
// (tasks/ces.py, distributions/censored_sigmoid_normal.py).  For every
// draw l = (rho, alpha, log u) of the chunk, row b and step t it computes
//
//     w_k   = sum_i alpha_i x_{k,i}^rho     (basket k = 1, 2 of the design,
//                                            x clamped to [0.01, 100])
//     mu    = (w_1^(1/rho) - w_2^(1/rho)) u,   u = exp(log u)
//     sigma = (1 + |b1 - b2|) noise u,     z(v) = (logit v - mu) / sigma
//     ll    = log_ndtr(-z(hi))                   at y = hi = 1 - eps
//             log_ndtr(z(lo))                    at y = lo = eps
//             N(logit y; mu, sigma) - log y - log(1 - y)   inside
//             -inf                               outside [lo, hi]
//     S_lbt = sum_{s <= t} ll_lbs
//
// and folds S over l into the (max, sumexp) state of each (b, t), as
// parallel/collectives.py lse_update does; draws from n_valid on (the
// padding past L) add nothing.  In plain PyTorch the fold wrote about
// twenty [Lc, B, Th] and [Lc, B, Th, 3] blocks to device memory (the
// powers, the sums, the three branches of the density), ran a cumulative
// sum along the 16-element step axis (5.8 s of a 9.2 s batch at the BED
// cell's shape: the scan kernel runs ~145x slower than its bytes) and
// three more passes for the logsumexp.  Here no such block exists.
//
// What bounds it.  The special functions: per term six powers x^rho, two
// outer powers w^(1/rho), the density's or the tail's logs, and the
// fold's exp: 11 special-function results (portbench/counts/ces_fold.py),
// 42.1 ms a batch of L = 1e7, B = 100, Th = 16 (1.6e10 terms) at 4.18e12
// results a second.  The bytes are a few MB a chunk.  Each accurate powf,
// logf, erfcxf/erfcf and IEEE division is a sequence of FMA-pipe
// instructions around one or two MUFU results, so the issue rate (4
// instructions a clock an SM) bounds the kernel, at some hundreds of
// instructions a term, most of them the eight powf.
//
// Why powf, and the plain version's rounding.  The outer power
// multiplies the relative rounding of w by 1 / rho, up to 100, and the
// z-score divides the utilities by sigma = (1 + |b1 - b2|) noise u, down
// to 1e-4 of them: an ulp of w moves a draw's log-likelihood by up to
// 1e-3 over the 16 steps.  Any other rounding of the utilities than the
// plain version's (exp2 of rho log2 x hoisted per (b, t), a hoisted
// mu / sigma) moved the bounds by up to 4e-3 against the plain
// reference of the benchmark, its whole limit.  So a term rounds as the
// plain version does on the card: powf(x, rho) and powf(w, 1 / rho), the
// products alpha_i x_i^rho rounded and summed in torch.sum's order on the
// card ((first + third) + second, as |b1 - b2|^2), mu = (U1 - U2) u,
// sigma = s0 u and z = (logit y - mu) / sigma rounded one operation at a
// time (the _rn intrinsics: no contraction into FMAs), and inside the
// limits -(z^2 + log 2 pi) / 2 - log sigma - log y - log(1 - y) in the
// plain version's order.  Only log_ndtr is this file's own (CUDA's
// erfcxf and erfcf in torch's float32 form: log(erfcx(-x / sqrt 2) / 2) -
// x^2 / 2 for x < -1, else log1p(-erfc(x / sqrt 2) / 2)); its rounding
// is relative to the term, which is near 0 for the draws that carry the
// logsumexp.
//
// Design.  The skeleton and the streaming logsumexp are loc_eig_fold.cu's
// (eig_fold_reduce.cuh): a block of kThreads threads takes row b and
// kBlockDraws draws, thread tid owning draws g * kBlockDraws + j *
// kThreads + tid, j < kDraws; all threads walk t together, each keeping its
// draws' running sums in registers, and reduce them step by step in a fixed
// order (no atomics: bitwise repeatable, and any grouping of chunks into
// calls gives the same bounds).  The grid covers only the valid draws.
// What CES adds is the hoisting of what a term does not need to redo:
//  * per (b, t), once into the block's shared tile of steps: the six
//    clamped goods, s0 = (1 + |b1 - b2|) noise, log y, log(1 - y), logit y
//    and which branch y takes.  Every thread of a block shares (b, t), so
//    the branch is uniform across the block: a term computes only the one
//    y selects, where the plain fold computes all three for every term.
//  * per (l, b), once into registers: rho, 1 / rho, alpha, u = exp(log u).
//
// tests/test_torch_eig_fold.py emulates this arithmetic and order in
// PyTorch on the CPU (and reads kThreads, kDraws and kTileMax from this
// file); tests/test_torch_cuda.py holds the kernel to its plain version
// on the card.

#include <cuda_runtime.h>
#include <math.h>

#include "eig_fold_reduce.cuh"

namespace {

constexpr int kThreads = 128;                 // a block's threads
constexpr int kDraws = 4;                     // draws a thread folds
constexpr int kBlockDraws = kThreads * kDraws;
constexpr int kTileMax = 32;                  // steps of a shared tile
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kSqrtHalf = 0.70710678118654752f;

enum Branch : int { kInside = 0, kUpper = 1, kLower = 2, kOutside = 3 };

// What a (b, t) term needs that does not depend on the draw
struct Step {
  float xc[6];    // the goods clamped to [0.01, 100], basket 1 then 2
  float s0;       // (1 + |b1 - b2|) noise
  float log_y, log_1y, logit;
  int branch;
};

__device__ __forceinline__ Step make_step(const float* xt, float yt,
                                          float noise, float lower,
                                          float upper) {
  Step st;
#pragma unroll
  for (int k = 0; k < 6; ++k) st.xc[k] = fminf(fmaxf(xt[k], 0.01f), 100.0f);
  float sq[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d = __fsub_rn(st.xc[k], st.xc[k + 3]);
    sq[k] = __fmul_rn(d, d);
  }
  const float dist = sqrtf(__fadd_rn(__fadd_rn(sq[0], sq[2]), sq[1]));
  st.s0 = __fmul_rn(__fadd_rn(1.0f, dist), noise);
  st.log_y = logf(yt);
  st.log_1y = log1pf(-yt);
  st.logit = __fsub_rn(st.log_y, st.log_1y);
  st.branch = yt == upper   ? kUpper
              : yt == lower ? kLower
              : (yt > upper || yt < lower) ? kOutside
                                            : kInside;
  return st;
}

// log Phi(x) in torch's float32 form
__device__ __forceinline__ float log_ndtr(float x) {
  const float t = x * kSqrtHalf;
  if (x < -1.0f) return logf(erfcxf(-t) * 0.5f) - t * t;
  return log1pf(-erfcf(t) * 0.5f);
}

// (sum_i alpha_i x_i^rho)^(1/rho) of basket xc[0..2], rounded as the
// plain version rounds it (torch.sum over the 3 goods on the card adds
// the third to the first, then the second)
__device__ __forceinline__ float utility(const float* xc, float rho,
                                         float inv_rho, const float* al) {
  const float w = __fadd_rn(__fadd_rn(__fmul_rn(al[0], powf(xc[0], rho)),
                                      __fmul_rn(al[2], powf(xc[2], rho))),
                            __fmul_rn(al[1], powf(xc[1], rho)));
  return powf(w, inv_rho);
}

// Each block's partial (max, sumexp) of every step, [G, B, Th]
__global__ void __launch_bounds__(kThreads)
    fold_partials(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ thetas, float2* __restrict__ part,
                  long long n_valid, int B, int Th, int tile, float noise,
                  float lower, float upper) {
  extern __shared__ float2 slots[];            // [tile][kThreads], then
  Step* steps = reinterpret_cast<Step*>(slots + tile * kThreads);  // [tile]
  const int b = blockIdx.x % B;
  const long long g = blockIdx.x / B;
  const int tid = threadIdx.x;

  // the draws: rho, 1 / rho, alpha, u (a draw past n_valid reads draw 0
  // and is left out of the reduction)
  float rho[kDraws], inv_rho[kDraws], al[kDraws][3], u[kDraws], S[kDraws];
  int nj = 0;                                  // valid draws: a prefix of j
#pragma unroll
  for (int j = 0; j < kDraws; ++j) {
    const long long l = g * kBlockDraws + (long long)j * kThreads + tid;
    const bool valid = l < n_valid;
    nj += valid;
    const float* th = thetas + ((valid ? l : 0) * B + b) * 5;
    rho[j] = __ldg(th);
#pragma unroll
    for (int i = 0; i < 3; ++i) al[j][i] = __ldg(th + 1 + i);
    inv_rho[j] = __fdiv_rn(1.0f, rho[j]);
    u[j] = expf(__ldg(th + 4));
    S[j] = 0.0f;
  }

  for (int t0 = 0; t0 < Th; t0 += tile) {
    const int nt = min(tile, Th - t0);
    for (int i = tid; i < nt; i += kThreads) {
      const long long bt = (long long)b * Th + t0 + i;
      steps[i] = make_step(x + bt * 6, __ldg(y + bt), noise, lower, upper);
    }
    __syncthreads();
    for (int i = 0; i < nt; ++i) {
      const Step& st = steps[i];
      if (st.branch == kOutside) {
#pragma unroll
        for (int j = 0; j < kDraws; ++j) S[j] = -INFINITY;
      } else {
#pragma unroll
        for (int j = 0; j < kDraws; ++j) {
          const float udiff =
              __fsub_rn(utility(st.xc, rho[j], inv_rho[j], al[j]),
                        utility(st.xc + 3, rho[j], inv_rho[j], al[j]));
          const float sigma = __fmul_rn(st.s0, u[j]);
          const float z = __fdiv_rn(__fsub_rn(st.logit, __fmul_rn(udiff, u[j])),
                                    sigma);
          // uniform across the block: every thread has this (b, t)
          float ll;
          if (st.branch == kInside) {
            const float q = __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(z, z),
                                                       kLog2Pi));
            ll = __fsub_rn(__fsub_rn(__fsub_rn(q, logf(sigma)), st.log_y),
                           st.log_1y);
          } else {
            ll = log_ndtr(st.branch == kUpper ? -z : z);
          }
          S[j] += ll;
        }
      }
      slots[i * kThreads + tid] = eig_fold::thread_pair(S, nj);
    }
    __syncthreads();
    eig_fold::tile_partials<kThreads>(slots, nt, part + (g * B + b) * Th + t0);
    __syncthreads();
  }
}

}  // namespace

// Floats of scratch (the blocks' partials) a call with n_valid valid
// draws, B rows and Th steps needs.
extern "C" long long ces_eig_fold_scratch(long long n_valid, int B, int Th) {
  return 2 * eig_fold::n_groups(n_valid, kBlockDraws) * B * Th;
}

// One chunk folded into the state: x [B, Th, 6] designs (two baskets of
// 3 goods), y [B, Th] outcomes, thetas [>= n_valid, B, 5] (rho, alpha_1..3,
// log u), the state's max and sumexp [B, Th] in, the new state out; all
// float32, contiguous.  lower and upper are the censoring limits eps and
// 1 - eps as float32.
extern "C" int ces_eig_fold(const void* x, const void* y, const void* thetas,
                            const void* max_in, const void* sumexp_in,
                            void* max_out, void* sumexp_out, void* scratch,
                            long long n_valid, int B, int Th,
                            float noise_scale, float lower, float upper,
                            void* stream) {
  if (B <= 0 || Th <= 0) return 0;
  if (n_valid < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long G = eig_fold::n_groups(n_valid, kBlockDraws);
  const long long n = (long long)B * Th;
  float2* part = static_cast<float2*>(scratch);
  if (G > 0) {
    if (G * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int tile = eig_fold::tile_steps(Th, kTileMax);
    const size_t smem = (size_t)tile * (kThreads * sizeof(float2) +
                                        sizeof(Step));
    fold_partials<<<(unsigned)(G * B), kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(thetas), part, n_valid, B, Th, tile,
        noise_scale, lower, upper);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)eig_fold::launch_merge(
      part, G, n, static_cast<const float*>(max_in),
      static_cast<const float*>(sumexp_in), static_cast<float*>(max_out),
      static_cast<float*>(sumexp_out), s);
}
