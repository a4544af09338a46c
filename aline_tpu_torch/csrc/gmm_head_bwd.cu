// Fused GMM-posterior-head backward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel aline_tpu/ops/gmm_head_kernel.py:41
// (_bwd_kernel, entered through _fused_bwd).  The forward computes, per
// token row z (D floats) and mixture component c,
//
//     pre = z . W1[c] + b1[c]          (F values)
//     out = relu(pre) . W2[c] + b2[c]  (3 values)
//
// Given g = dL/dout [rows, C, 3] this kernel returns
//
//     dh_c = (g_c . W2[c]^T) * [pre_c > 0]       (never stored)
//     dz   = sum_c dh_c . W1[c]^T                [rows, D]
//     dW1  = sum_rows z^T dh_c    db1 = sum_rows dh_c
//     dW2  = sum_rows relu(pre_c)^T g_c          db2 = sum_rows g_c
//
// The [rows, C, F] hidden tensor of the two-einsum backward (104 MB a
// training step at B=200, T=102, C=10, F=128) never reaches device memory.
//
// What bounds it.  Per row and component: 2*D*F FLOP to recompute pre,
// 2*D*F for dz, 2*D*F for dW1, and about 4*3*F for dh, dW2 and db1.  At
// the flagship shapes (D=32, F=128, C=10) that is 26,112 FLOP per row and
// component against 4*(2*D + 3*C) = 376 bytes per row: float32 FMA work
// outside the tensor cores (67 TFLOP/s on an H100 SXM) bounds it.
//
// Design (simple and deterministic first; wgmma/TMA are later work):
//  * The TPU kernel sums the weight gradients into grid-revisited blocks,
//    which relies on the TPU running its grid in order.  Here blocks run
//    in any order, so each CTA of kThreads rows writes its own partial
//    dW1/db1/dW2/db2 to a scratch buffer [n_ctas][C * (D*F + 4*F + 3)],
//    and a second kernel sums the partials over CTAs in a fixed order.
//    No float atomics: the gradients are bitwise the same on every run.
//  * Phase A (one thread per row, z and the dz sum in registers): for
//    each component the CTA stages W1[c] transposed and (b1, W2) packed
//    as one float4 per hidden unit in shared memory, as the forward does.
//    A thread recomputes pre for its row in the forward's summation order
//    (so the relu mask is the forward's), stores it in shared memory,
//    and adds dh * W1[c][:, f] to its dz.  The sum over components stays
//    inside the thread.
//  * Phase B (one thread per hidden unit f): the thread walks the CTA's
//    rows in order, rebuilds h and dh from the stored pre and the row's
//    g, and accumulates dW1[c][:, f] (D registers), dW2[c][f, :], db1[c][f].
//    z rows are read from global memory as warp-wide broadcasts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // rows of a CTA, and threads of a CTA
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ inline long long per_cta(int D, int C, int F) {
  return (long long)C * ((long long)D * F + 4LL * F + 3);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
gmm_head_bwd_kernel(const float* __restrict__ z, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ g, float* __restrict__ dz,
                    float* __restrict__ part, long long rows, int C, int F) {
  constexpr int DP = D + 4;  // padded row of the transposed W1[c] tile
  const int FP = F + 1;      // padded row of the pre tile: conflict-free
  extern __shared__ float4 smem[];
  float4* pk = smem;                                   // [F] (b1, w2_0..2)
  float4* gs = smem + F;                               // [kThreads] g rows
  float* w1t = reinterpret_cast<float*>(smem + F + kThreads);  // [F][DP]
  float* pre = w1t + F * DP;                           // [kThreads][FP]

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kThreads;
  const long long row = row0 + tid;
  const bool live = row < rows;
  const int nlive = (int)min((long long)kThreads, rows - row0);

  float zr[D], dzr[D];
  {
    const float4* src = reinterpret_cast<const float4*>(z + row * D);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) v = src[d4];
      zr[4 * d4 + 0] = v.x;
      zr[4 * d4 + 1] = v.y;
      zr[4 * d4 + 2] = v.z;
      zr[4 * d4 + 3] = v.w;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dzr[d] = 0.f;

  const long long DF = (long long)D * F;
  float* p_dw1 = part + (long long)blockIdx.x * per_cta(D, C, F);
  float* p_db1 = p_dw1 + C * DF;
  float* p_dw2 = p_db1 + (long long)C * F;
  float* p_db2 = p_dw2 + (long long)C * F * 3;

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // every thread is done with the previous component
    const float* w1c = w1 + (size_t)c * D * F;
    for (int i = tid; i < D * F; i += kThreads) {
      const int d = i / F, f = i - d * F;   // coalesced read of W1[c][d][f]
      w1t[f * DP + d] = w1c[i];
    }
    for (int f = tid; f < F; f += kThreads) {
      const float* w2f = w2 + ((size_t)c * F + f) * 3;
      pk[f] = make_float4(b1[(size_t)c * F + f], w2f[0], w2f[1], w2f[2]);
    }
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (live) {
      const float* gr = g + (row * C + c) * 3;
      g0 = gr[0];
      g1 = gr[1];
      g2 = gr[2];
    }
    gs[tid] = make_float4(g0, g1, g2, 0.f);
    __syncthreads();

    // Phase A: pre for this row (the forward's order), dz += dh W1[c]^T.
    for (int f = 0; f < F; ++f) {
      const float4 p = pk[f];
      const float4* wrow = reinterpret_cast<const float4*>(w1t + f * DP);
      float h = p.x;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 w = wrow[d4];
        h = fmaf(zr[4 * d4 + 0], w.x, h);
        h = fmaf(zr[4 * d4 + 1], w.y, h);
        h = fmaf(zr[4 * d4 + 2], w.z, h);
        h = fmaf(zr[4 * d4 + 3], w.w, h);
      }
      pre[tid * FP + f] = h;
      float gw = g0 * p.y;
      gw = fmaf(g1, p.z, gw);
      gw = fmaf(g2, p.w, gw);
      const float dh = h > 0.f ? gw : 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 w = wrow[d4];
        dzr[4 * d4 + 0] = fmaf(dh, w.x, dzr[4 * d4 + 0]);
        dzr[4 * d4 + 1] = fmaf(dh, w.y, dzr[4 * d4 + 1]);
        dzr[4 * d4 + 2] = fmaf(dh, w.z, dzr[4 * d4 + 2]);
        dzr[4 * d4 + 3] = fmaf(dh, w.w, dzr[4 * d4 + 3]);
      }
    }
    __syncthreads();

    // Phase B: this CTA's partial weight gradients, one hidden unit f per
    // thread, rows summed in order.
    for (int f = tid; f < F; f += kThreads) {
      const float4 p = pk[f];
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = 0.f;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, ab = 0.f;
      for (int r = 0; r < nlive; ++r) {
        const float pr = pre[r * FP + f];
        const float4 gr = gs[r];
        const float h = fmaxf(pr, 0.f);
        a0 = fmaf(h, gr.x, a0);
        a1 = fmaf(h, gr.y, a1);
        a2 = fmaf(h, gr.z, a2);
        float gw = gr.x * p.y;
        gw = fmaf(gr.y, p.z, gw);
        gw = fmaf(gr.z, p.w, gw);
        const float dh = pr > 0.f ? gw : 0.f;
        ab += dh;
        const float4* zrow =
            reinterpret_cast<const float4*>(z + (row0 + r) * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 zv = __ldg(zrow + d4);
          acc[4 * d4 + 0] = fmaf(zv.x, dh, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(zv.y, dh, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(zv.z, dh, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(zv.w, dh, acc[4 * d4 + 3]);
        }
      }
      float* dst = p_dw1 + c * DF + f;   // coalesced over f
#pragma unroll
      for (int d = 0; d < D; ++d) dst[(long long)d * F] = acc[d];
      p_db1[(long long)c * F + f] = ab;
      float* d2 = p_dw2 + ((long long)c * F + f) * 3;
      d2[0] = a0;
      d2[1] = a1;
      d2[2] = a2;
    }
    if (tid < 3) {
      float s = 0.f;
      for (int r = 0; r < nlive; ++r) {
        const float4 gr = gs[r];
        s += tid == 0 ? gr.x : (tid == 1 ? gr.y : gr.z);
      }
      p_db2[c * 3 + tid] = s;
    }
  }

  if (live) {
    float4* out = reinterpret_cast<float4*>(dz + row * D);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4)
      out[d4] = make_float4(dzr[4 * d4 + 0], dzr[4 * d4 + 1],
                            dzr[4 * d4 + 2], dzr[4 * d4 + 3]);
  }
}

// out[i] = sum over CTAs b = 0, 1, ... of part[b][i], in that order.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, long long n,
                                    int n_ctas) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_ctas; ++b) s += part[(long long)b * n + i];
  out[i] = s;
}

template <int D>
cudaError_t launch(const float* z, const float* w1, const float* b1,
                   const float* w2, const float* g, float* dz, float* part,
                   float* grads, long long rows, int C, int F,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(F + kThreads) * sizeof(float4) +
                      (size_t)F * (D + 4) * sizeof(float) +
                      (size_t)kThreads * (F + 1) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_head_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long ctas = (rows + kThreads - 1) / kThreads;
  gmm_head_bwd_kernel<D><<<(unsigned)ctas, kThreads, smem, stream>>>(
      z, w1, b1, w2, g, dz, part, rows, C, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = per_cta(D, C, F);
  const int threads = 256;
  sum_partials_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        stream>>>(part, grads, n, (int)ctas);
  return cudaGetLastError();
}

}  // namespace

// Rows a CTA takes, so the caller can size the partials buffer:
// part holds ceil(rows / gmm_head_bwd_rows_per_cta()) * C*(D*F + 4F + 3)
// floats.
extern "C" int gmm_head_bwd_rows_per_cta() { return kThreads; }

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous float32 arrays; z and dz must be 16-byte aligned.  grads
// receives [dW1 (C*D*F) | db1 (C*F) | dW2 (C*F*3) | db2 (C*3)].  Returns
// the cudaError_t of the launches (0 = launched).
extern "C" int gmm_head_bwd(const void* z, const void* w1, const void* b1,
                            const void* w2, const void* g, void* dz,
                            void* part, void* grads, long long rows, int D,
                            int C, int F, void* stream) {
  if (rows <= 0) return 0;
  const float* zf = static_cast<const float*>(z);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* gf = static_cast<const float*>(g);
  float* dzf = static_cast<float*>(dz);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(grads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(zf, w1f, b1f, w2f, gf, dzf, pf, of, rows, C, F, s);
    case 32:
      return launch<32>(zf, w1f, b1f, w2f, gf, dzf, pf, of, rows, C, F, s);
    case 64:
      return launch<64>(zf, w1f, b1f, w2f, gf, dzf, pf, of, rows, C, F, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
