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
// What bounds it.  A row costs 2*C*D*F FLOP in the product z . W1[c] and
// 2*C*3*F in the rank-3 product with W2[c]; it moves 4*(D + 3*C) bytes.
// At the flagship shapes (D=32, F=128, C=10; B=100, T=2001) that is 16.39
// GFLOP + 1.54 GFLOP against 49.6 MB.  On float32 FMAs alone (67 TFLOP/s,
// H100 SXM) the bound is 0.2676 ms.  With the D x F product on the tensor
// cores as 3xTF32 (three TF32 products at 495 TFLOP/s) and the rest on
// FMAs it is 0.1223 ms; mma.sync reaches about 320 TFLOP/s of TF32 on an
// H100 (scripts/measure_gmm_ceilings.py; the 495 need wgmma), which puts
// this design's floor near 0.18 ms.  The bytes (0.015 ms) never bound it.
//
// Design.
//  * A warp's task is 32 rows (two 16-row mma tiles sharing each B
//    fragment; one tile at D=64, whose Z fragments would not fit twice).
//    Rows are the flattened B*T token axis; the ragged last task reads
//    zeros and writes nothing, so the caller pads nothing.
//  * CTAs of 8 warps, at most 2 an SM, walk contiguous runs of tasks.  When
//    there are fewer tasks than warps in such a grid (the T=102 target
//    sets), the C components are split over CTAs too (gridDim.y groups), so
//    the card fills: at B=100, T=102, 46 x 5 CTAs of 7 tasks and 2
//    components.  Outputs of different components never meet, so the split
//    changes no sum.
//  * Per component: its W1, b1, W2 sit in a shared-memory stage, copied by
//    cp.async while the previous component computed; the CTA splits W1[c]
//    into (hi, lo) pairs and packs (b1, W2) per hidden unit, then starts
//    the next copy.  A warp with one task keeps its Z fragments in
//    registers across components; otherwise it reloads them from device
//    memory (L2) per task.
//  * Per 8-column tile of F, two tiles a turn: pre from gmm::pre_tile
//    (shared with the backward), relu and the three FMAs against W2[c] in
//    registers on the accumulator fragment; each thread sums its columns,
//    a quad shuffle (xor 1, then xor 2) sums the row over F, and b2 is
//    added last: out = (sum over the thread's columns in order, then the
//    quad tree) + b2.
//
// The first form, for the record: one thread per 2 rows, W1[c] transposed in
// shared memory, every product on FMAs, 256 rows a block.  It measured
// 0.4911 ms at T=2001 (54% of the FMA bound) and 0.1130 ms at B=200,
// T=102 (24%) on an H100 80GB HBM3 at 700 W (chip_smoke.py, device time):
// at T=102 its 40-80 blocks left most of the 132 SMs idle, and the FMA
// bound capped it at T=2001.  Hence the tensor cores and the grid that
// splits components.  Timed in turns with the first form in one call, this
// one was faster at every main-path shape (PERF.md, section 6).  Whether a
// well register-tiled FMA form would beat it at T=2001 is not measured.
//
// Wide heads (D and F multiples of 128, the wrapper zero-pads other widths
// past the narrow ones): W1[c] no longer fits in shared memory (16 MiB at
// D = 1024, F = 4096), and the product is a real tensor-core workload (2
// rows D F C FLOP: 16.8 TFLOP at B=100, T=2001, C=10: 0.10 s at the 3xTF32
// bound, far above its 0.8 GB of z).  gmm_head_fwd_tiled_kernel is one CTA
// per (128 rows, component): over F in chunks of 128 it runs the tiled
// mainloop of gmm_tiled.cuh (pre = Z . W1[c][:, chunk], K = D in steps of
// 32 through a cp.async ring), and its epilogue adds b1, takes relu and the
// three FMAs against W2[c] into the row's outputs in registers.  A row's
// output sums over the thread's columns chunk by chunk, then over the quad
// (xor 1, 2), then over the two warps along F in order, plus b2: a fixed
// order, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gmm_head_common.cuh"
#include "gmm_tiled.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCtasPerSm = 2;

// the split W1[c], the packed (b1, W2) and the stage: 206,848 B at the
// widest (D=64, F=256), within sm_90's 227 KB a block
size_t smem_bytes(int D, int F) {
  return (size_t)D * gmm::split_stride(F) * sizeof(float2) +
         (size_t)F * sizeof(float4) +
         (size_t)gmm::stage_floats(D, F) * sizeof(float);
}

// this warp's task: MT 16-row tiles from row r0, as split A fragments
template <int D, int MT>
__device__ __forceinline__ void load_rows(gmm::FragA (&a)[MT][D / 8],
                                          const float* __restrict__ z,
                                          long long r0, long long rows) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      a[m][ks] = gmm::load_a_global(z, D, r0 + 16 * m, rows, 8 * ks);
}

template <int D, int MT>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
gmm_head_fwd_kernel(const float* __restrict__ z, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    long long rows, int C, int F, int tasks_per_cta,
                    int comps_per_cta) {
  constexpr int kTaskRows = 16 * MT;
  const int ws = gmm::split_stride(F);
  extern __shared__ float4 smem[];
  float2* w1s = reinterpret_cast<float2*>(smem);            // [D][ws]
  float4* pk = reinterpret_cast<float4*>(w1s + D * ws);     // [F]
  float* stage = reinterpret_cast<float*>(pk + F);          // W1c, b1c, W2c

  const int warp = threadIdx.x >> 5, g = gmm::lane_g(), t = gmm::lane_t();
  const long long n_tasks = (rows + kTaskRows - 1) / kTaskRows;
  const long long first = (long long)blockIdx.x * tasks_per_cta;
  const long long last = min(first + tasks_per_cta, n_tasks);
  // a warp with at most one task keeps its rows for all components
  const bool resident = last - first <= kWarps;
  // this CTA's components: [c_first, c_last)
  const int c_first = blockIdx.y * comps_per_cta;
  const int c_last = min(C, c_first + comps_per_cta);
  gmm::stage_component(stage, w1, b1, w2, c_first, D, F);
  gmm::FragA a[MT][D / 8];
  if (resident && first + warp < last)
    load_rows<D, MT>(a, z, (first + warp) * kTaskRows, rows);

  for (int c = c_first; c < c_last; ++c) {
    gmm::cp_async_wait_all();
    __syncthreads();  // stage holds c; every warp is done with c - 1
    gmm::unpack_component(w1s, ws, pk, stage, stage + D * F,
                          stage + D * F + F, D, F);
    __syncthreads();
    if (c + 1 < c_last)
      gmm::stage_component(stage, w1, b1, w2, c + 1, D, F);
    const float bias = __ldg(b2 + 3 * c + min(t, 2));  // output t's b2

    for (long long task = first + warp; task < last; task += kWarps) {
      const long long r0 = task * kTaskRows;
      if (!resident) load_rows<D, MT>(a, z, r0, rows);
      float o[MT][2][3] = {};  // rows g, g + 8 of each tile
      // one 8-column tile: pre, relu, and its three FMAs per row into o
      auto tile = [&](int col0) {
        gmm::FragB b[D / 8];
        gmm::load_w1<D>(b, w1s, ws, col0);
        const float4 p0 = pk[col0 + 2 * t], p1 = pk[col0 + 2 * t + 1];
        float acc[MT][4];
        gmm::pre_tile<D, MT>(acc, a, b, p0.x, p1.x);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x0 = fmaxf(acc[m][2 * h], 0.f);
            const float x1 = fmaxf(acc[m][2 * h + 1], 0.f);
            o[m][h][0] = fmaf(x1, p1.y, fmaf(x0, p0.y, o[m][h][0]));
            o[m][h][1] = fmaf(x1, p1.z, fmaf(x0, p0.z, o[m][h][1]));
            o[m][h][2] = fmaf(x1, p1.w, fmaf(x0, p0.w, o[m][h][2]));
          }
        }
      };
      // two tiles a turn, so their products overlap on the tensor core
      int col0 = 0;
      for (; col0 + 8 < F; col0 += 16) {
        tile(col0);
        tile(col0 + 8);
      }
      if (col0 < F) tile(col0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            o[m][h][j] += __shfl_xor_sync(0xffffffffu, o[m][h][j], 1);
            o[m][h][j] += __shfl_xor_sync(0xffffffffu, o[m][h][j], 2);
          }
          // lane t < 3 of the quad writes output t of the row
          const long long r = r0 + 16 * m + g + 8 * h;
          if (t < 3 && r < rows) {
            const float v =
                t == 0 ? o[m][h][0] : (t == 1 ? o[m][h][1] : o[m][h][2]);
            out[(r * C + c) * 3 + t] = v + bias;
          }
        }
      }
    }
  }
}

template <int D, int MT>
cudaError_t launch(const float* z, const float* w1, const float* b1,
                   const float* w2, const float* b2, float* out,
                   long long rows, int C, int F, cudaStream_t stream) {
  static int granted[gmm::kMaxDevices] = {};
  gmm::DeviceInfo info;
  cudaError_t e = gmm::device_info(&info);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(D, F);
  if (smem > (size_t)info.max_smem) return cudaErrorInvalidValue;
  e = gmm::allow_smem((const void*)gmm_head_fwd_kernel<D, MT>, smem, info.dev,
                      granted);
  if (e != cudaSuccess) return e;
  // Row tasks over at most kCtasPerSm CTAs an SM.  When there are fewer
  // tasks than warps in such a grid, the components are split over CTAs
  // too (gridDim.y groups), so that every warp has a task.
  const long long tasks = (rows + 16 * MT - 1) / (16 * MT);
  const long long most = (long long)info.sms * kCtasPerSm;
  long long groups = 1;
  if (tasks < most * kWarps)
    groups = std::max(1LL, std::min<long long>(C, most * kWarps / tasks));
  const int per_group = (int)((C + groups - 1) / groups);
  groups = (C + per_group - 1) / per_group;
  long long per = (tasks * groups + most - 1) / most;
  if (groups > 1) per = std::min<long long>(per, kWarps);
  const dim3 grid((unsigned)((tasks + per - 1) / per), (unsigned)groups);
  gmm_head_fwd_kernel<D, MT><<<grid, kThreads, smem, stream>>>(
      z, w1, b1, w2, b2, out, rows, C, F, (int)per, per_group);
  return cudaGetLastError();
}

// The wide form (see the note at the top): one CTA per 128 rows and
// component, over F in chunks of 128.
__global__ void __launch_bounds__(gmm::tiled::kThreads, 2)
gmm_head_fwd_tiled_kernel(const float* __restrict__ z,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ w2,
                          const float* __restrict__ b2,
                          float* __restrict__ out, long long rows, int D,
                          int C, int F) {
  using namespace gmm::tiled;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.y, t = gmm::lane_t();
  const long long m0 = (long long)blockIdx.x * kBM;
  const float* w1c = w1 + (size_t)c * D * F;
  const float* b1c = b1 + (size_t)c * F;
  const float* w2c = w2 + (size_t)c * F * 3;
  float o[kMT][2][3] = {};  // the thread's rows (mt, half): their 3 outputs
  Acc acc;
  for (int n0 = 0; n0 < F; n0 += kBN) {
    mainloop<kMK, kKN>(acc, z, D, w1c, F, m0, n0, rows, D, smem);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = n0 + acc_col(nt, j);
        const float bias = __ldg(b1c + f);
        const float v0 = __ldg(w2c + 3 * f), v1 = __ldg(w2c + 3 * f + 1),
                    v2 = __ldg(w2c + 3 * f + 2);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = fmaxf(acc.v[mt][nt][2 * h + j] + bias, 0.f);
            o[mt][h][0] = fmaf(x, v0, o[mt][h][0]);
            o[mt][h][1] = fmaf(x, v1, o[mt][h][1]);
            o[mt][h][2] = fmaf(x, v2, o[mt][h][2]);
          }
      }
    }
  }
  // the quad's columns, then the two warps along F in order (the ring is
  // free: the last mainloop ended synchronised)
  float* red = smem;  // [2][kBM][3]
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float x = o[mt][h][j];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (t == 0) red[(warp_n() * kBM + acc_row(mt, 2 * h)) * 3 + j] = x;
      }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * 3; i += kThreads) {
    const long long r = m0 + i / 3;
    const int j = i % 3;
    if (r < rows)
      out[(r * C + c) * 3 + j] =
          red[i] + red[kBM * 3 + i] + __ldg(b2 + 3 * c + j);
  }
}

cudaError_t launch_tiled(const float* z, const float* w1, const float* b1,
                         const float* w2, const float* b2, float* out,
                         long long rows, int D, int C, int F,
                         cudaStream_t stream) {
  using namespace gmm::tiled;
  static int granted[gmm::kMaxDevices] = {};
  gmm::DeviceInfo info;
  cudaError_t e = gmm::device_info(&info);
  if (e != cudaSuccess) return e;
  const size_t smem = Gemm<kMK, kKN>::SMEM;
  e = gmm::allow_smem((const void*)gmm_head_fwd_tiled_kernel, smem, info.dev,
                      granted);
  if (e != cudaSuccess) return e;
  const long long tiles = (rows + kBM - 1) / kBM;
  if (tiles > 0x7fffffffLL || C > 65535) return cudaErrorInvalidConfiguration;
  gmm_head_fwd_tiled_kernel<<<dim3((unsigned)tiles, (unsigned)C), kThreads,
                              smem, stream>>>(z, w1, b1, w2, b2, out, rows, D,
                                              C, F);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous float32 arrays; z, w1, b1 and w2 must be 16-byte aligned.
// The widths: D in {16, 32, 64} with F a multiple of 8 up to gmm::kMaxF
// (the narrow kernel), or D and F multiples of 128 (the tiled one).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int gmm_head_fwd(const void* z, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            long long rows, int D, int C, int F,
                            void* stream) {
  if (rows <= 0) return 0;
  const bool narrow = gmm::narrow_takes(D, F);
  if (!narrow && !gmm::tiled::takes(D, F)) return (int)cudaErrorInvalidValue;
  const float* zf = static_cast<const float*>(z);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!narrow)
    return (int)launch_tiled(zf, w1f, b1f, w2f, b2f, of, rows, D, C, F, s);
  switch (D) {
    // 32-row tasks (one B fragment serves two tiles); 16-row ones at
    // D = 64, whose two tiles of Z fragments take too many registers
    case 16: return launch<16, 2>(zf, w1f, b1f, w2f, b2f, of, rows, C, F, s);
    case 32: return launch<32, 2>(zf, w1f, b1f, w2f, b2f, of, rows, C, F, s);
    case 64: return launch<64, 1>(zf, w1f, b1f, w2f, b2f, of, rows, C, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
