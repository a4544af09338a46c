// Fused GMM-posterior-head forward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel aline_tpu/ops/gmm_head_kernel.py:27
// (_fwd_kernel, entered through fused_gmm_head).  For every token row z
// (D floats) and every mixture component c it computes
//
//     out[row, c, :] = relu(z . W1[c] + b1[c]) . W2[c] + b2[c]     (3 values)
//
// with W1 [C, D, F], b1 [C, F], W2 [C, F, 3], b2 [C, 3], out [rows, C, 3].
// The [rows, C, F] hidden activations never reach device memory, which is
// the point of the TPU kernel: the two-einsum formulation writes and reads
// that tensor (about 1 GB at B=100, T=2001, C=10, F=128).
//
// What bounds it.  At the flagship shapes (D=32, F=128, C=10) a row costs
// 2*C*(D*F + 3*F) = 89,600 FLOP and moves 4*(D + 3*C) = 248 bytes, about
// 360 FLOP per byte; float32 FMA work outside the tensor cores (67 TFLOP/s
// on an H100 SXM) bounds it, not memory.
//
// Design (simple and exact first; wgmma/TMA/tensor cores are later work):
//  * One thread owns kRowsPerThread rows and keeps their z in registers
//    (D is a template parameter, so the row arrays stay in registers).
//    Rows are the flattened B*T token axis; the ragged last block is masked
//    per row, so the caller pads nothing.
//  * A block loops over the C components.  Per component it stages W1[c]
//    transposed ([F][D], rows padded to D+4 floats) and (b1, W2) packed as
//    one float4 per hidden unit in shared memory; only one component's
//    weights are resident (18 KB at the flagship shapes), not all of W1.
//  * Every lane of a warp reads the same shared-memory word at the same
//    time (broadcast, conflict-free): per hidden unit f a thread does
//    D/4 float4 loads, kRowsPerThread*D FMAs for the pre-activation, a
//    relu, and 3 FMAs per row into the component's 3 outputs.  No
//    cross-thread reduction is needed.
//  * Sums accumulate in float32 in the order b1 + sum_d, then b2 + sum_f.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 2;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr size_t kDefaultSmem = 48 * 1024;

template <int D>
__global__ void __launch_bounds__(kThreads)
gmm_head_fwd_kernel(const float* __restrict__ z, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    long long rows, int C, int F) {
  constexpr int DP = D + 4;  // padded row of the transposed W1[c] tile
  extern __shared__ float4 smem[];
  float4* pk = smem;                                   // [F] (b1, w2_0..2)
  float* w1t = reinterpret_cast<float*>(smem + F);     // [F][DP]

  const long long first = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x;
  float zr[kRowsPerThread][D];
  bool live[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long row = first + (long long)r * kThreads;
    live[r] = row < rows;
    const float4* src = reinterpret_cast<const float4*>(z + row * D);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live[r]) v = src[d4];
      zr[r][4 * d4 + 0] = v.x;
      zr[r][4 * d4 + 1] = v.y;
      zr[r][4 * d4 + 2] = v.z;
      zr[r][4 * d4 + 3] = v.w;
    }
  }

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // every thread is done with the previous component
    const float* w1c = w1 + (size_t)c * D * F;
    for (int i = threadIdx.x; i < D * F; i += kThreads) {
      const int d = i / F, f = i - d * F;   // coalesced read of W1[c][d][f]
      w1t[f * DP + d] = w1c[i];
    }
    for (int f = threadIdx.x; f < F; f += kThreads) {
      const float* w2f = w2 + ((size_t)c * F + f) * 3;
      pk[f] = make_float4(b1[(size_t)c * F + f], w2f[0], w2f[1], w2f[2]);
    }
    __syncthreads();

    float acc[kRowsPerThread][3];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
      for (int o = 0; o < 3; ++o) acc[r][o] = 0.f;
    }
#pragma unroll 2
    for (int f = 0; f < F; ++f) {
      const float4 p = pk[f];
      const float4* wrow = reinterpret_cast<const float4*>(w1t + f * DP);
      float h[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) h[r] = p.x;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 w = wrow[d4];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          h[r] = fmaf(zr[r][4 * d4 + 0], w.x, h[r]);
          h[r] = fmaf(zr[r][4 * d4 + 1], w.y, h[r]);
          h[r] = fmaf(zr[r][4 * d4 + 2], w.z, h[r]);
          h[r] = fmaf(zr[r][4 * d4 + 3], w.w, h[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float hr = fmaxf(h[r], 0.f);
        acc[r][0] = fmaf(hr, p.y, acc[r][0]);
        acc[r][1] = fmaf(hr, p.z, acc[r][1]);
        acc[r][2] = fmaf(hr, p.w, acc[r][2]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      if (!live[r]) continue;
      float* dst = out + ((first + (long long)r * kThreads) * C + c) * 3;
#pragma unroll
      for (int o = 0; o < 3; ++o) dst[o] = acc[r][o] + b2[c * 3 + o];
    }
  }
}

template <int D>
cudaError_t launch(const float* z, const float* w1, const float* b1,
                   const float* w2, const float* b2, float* out,
                   long long rows, int C, int F, cudaStream_t stream) {
  const size_t smem = (size_t)F * sizeof(float4) + (size_t)F * (D + 4) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_head_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  gmm_head_fwd_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      z, w1, b1, w2, b2, out, rows, C, F);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous float32 arrays; z and out must be 16-byte aligned.  Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int gmm_head_fwd(const void* z, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            long long rows, int D, int C, int F,
                            void* stream) {
  if (rows <= 0) return 0;
  const float* zf = static_cast<const float*>(z);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(zf, w1f, b1f, w2f, b2f, of, rows, C, F, s);
    case 32: return launch<32>(zf, w1f, b1f, w2f, b2f, of, rows, C, F, s);
    case 64: return launch<64>(zf, w1f, b1f, w2f, b2f, of, rows, C, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
