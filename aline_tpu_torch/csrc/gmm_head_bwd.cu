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
// What bounds it.  Per row and component three D x F products (pre, dz,
// dW1: 6*D*F FLOP) and about 12*F FLOP of rank-3 work (dh, dW2, db1).  At
// the training shape (B=200, T=102, D=32, F=128, C=10) that is 5.33 GFLOP:
// 0.0795 ms on float32 FMAs alone (67 TFLOP/s, H100 SXM); 0.0351 ms with
// the three products on the tensor cores as 3xTF32 (495 TFLOP/s) and the
// rest on FMAs (mma.sync reaches about 320 TFLOP/s of TF32 on an H100,
// scripts/measure_gmm_ceilings.py: a floor near 0.052 ms).  Its bytes (z,
// g, dz and the weights) take far less.
//
// Design.
//  * One wave of persistent CTAs (8 warps, one CTA an SM): CTA b owns the
//    contiguous rows [b*L, (b+1)*L), L a whole number of steps chosen from
//    the row count and the SM count alone (plan_grid), so the grid,
//    and with it every sum, depends only on the shape and the device.  The
//    range's Z rows, split into TF32 (hi, lo), stay in shared memory for
//    all components, and so does the range's dz sum.
//  * Components on the outside; per component the CTA walks its range in
//    32-row steps (16 at D=64).  Component c's weights come from a stage
//    that cp.async filled while c-1 computed, split and packed as in the
//    forward (where the stage does not fit, they are split straight from
//    device memory).  g is loaded a step ahead.
//  * Per step, on mma.sync.m16n8k8 in 3xTF32 (gmm_head_common.cuh), warp w
//    owns hidden columns 8w + 64j:
//      - pre for the step's rows from gmm::pre_tile (the forward's
//        function, so the relu mask is bitwise the forward's); h, dh, dW2
//        and db1 in registers on the accumulator fragment; dh split into
//        shared memory for the dW1 product;
//      - dz's part over the warp's columns straight from the accumulator
//        fragment, which is the A operand of dh . W1[c]^T once the k index
//        runs over the tile's columns as 2t -> t, 2t+1 -> t+4
//        (gmm::a_from_acc, gmm::load_w1t); the 8 warps' parts meet in
//        shared memory and are added to the range's dz sum in warp order;
//      - dW1[c][:, w's columns] += Z^T . dh (K = the step's rows), summed
//        in registers across the whole range.
//    The ragged end of a range reads zero rows (z = 0 and g = 0 give zero
//    gradients) and writes nothing for them.
//  * At the end of each component the CTA writes its partial dW1[c],
//    db1[c], dW2[c], db2[c] once (dW2 and db1 summed over the fragment's
//    rows by a fixed xor-shuffle tree), into part[b]; a second kernel sums
//    the partials over b = 0, 1, ... in that order.  No float atomics: the
//    gradients are bitwise the same on every call.  Partials: grid x
//    C*(D*F + 4F + 3) floats, 128 copies = 23.6 MB at the training shape
//    (the first, all-FMA form wrote one per 128 rows: 160 copies, 29.5
//    MB).
//
// The first form, for the record: one thread per row for pre and dz, one
// thread per hidden unit walking the CTA's 128 rows for dW1, every product
// on FMAs.  It measured 0.5676 ms at the training shape (14% of the FMA
// bound) on an H100 80GB HBM3 at 700 W (chip_smoke.py, device time): its
// 88.6 KB of shared memory per 4-warp CTA let 4-8 warps run on an SM, each
// thread ran long dependent FMA chains, and its 160 partial copies took a
// fifth of the bound's time in traffic.  Hence the tensor cores, the
// register-resident dW1 sums and one wave of CTAs.  Timed in turns with
// the first form in one call, this one was faster (PERF.md, section 6).
// Whether a well register-tiled FMA form would beat it is not measured.
//
// Wide heads (D and F multiples of 128; gmm_tiled.cuh).  Here the design
// above fails twice: W1[c] does not fit in shared memory, and 128 partial
// copies of the weight gradients would take C (D F + 4 F + 3) floats each
// (21.6 GB at D = 1024, F = 4096, C = 10).  At the training shape (B=200,
// T=102) the three products take 5.1 TFLOP: 31 ms at the 3xTF32 bound,
// far above the bytes of any buffer below.  So per component c, four
// launches on the stream, each sum in a fixed order (no atomics, bitwise
// repeatable):
//  1. gmm_bwd_dh_kernel, one CTA per (128 rows, 128 hidden units): the
//     forward's mainloop and bias give pre bitwise as the forward has it;
//     the epilogue forms dh = (g . W2[c]^T) [pre > 0] and writes it to a
//     [rows, F] scratch (the only hidden-sized buffer: one component's,
//     334 MB at the training shape), and sums dW2 and db1 over its rows
//     (the thread's rows, the xor 4/8/16 tree, the 4 warps along M in
//     order) into one partial per row tile: [rows / 128, F, 4] floats;
//  2. gmm_bwd_sum_kernel sums those partials over the row tiles in order
//     (and db2's, the sums of g);
//  3. gmm_bwd_dz_kernel: dz (+)= dh . W1[c]^T, one CTA per (128 rows, 128
//     of D), adding to component c - 1's sum (c = 0 writes): dz sums over
//     the components in order;
//  4. gmm_bwd_dw1_kernel: dW1[c] = Z^T . dh, one CTA per (128 of D, 128 of
//     F) tile of the output, reducing over every row inside the CTA (K =
//     rows): no partial copies at all.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_head_common.cuh"
#include "gmm_tiled.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// floats of the gradients, and of one CTA's partial copy of them (padded
// to whole 16-byte chunks, so every copy is aligned)
__host__ __device__ inline long long grad_floats(int D, int C, int F) {
  return (long long)C * ((long long)D * F + 4LL * F + 3);
}
__host__ __device__ inline long long per_cta(int D, int C, int F) {
  return (grad_floats(D, C, F) + 3) / 4 * 4;
}

// rows a step: two 16-row mma tiles, or one at D = 64 (two tiles of its
// Z fragments take too many registers)
__host__ __device__ constexpr int step_rows(int D) { return D <= 32 ? 32 : 16; }

// shared memory of a CTA: fixed part (staged or not) + per range row
size_t fixed_bytes(int D, int F, bool staged) {
  const int ws = gmm::split_stride(F), step = step_rows(D);
  const int dzst = 2 * gmm::split_stride(D / 2);
  return (size_t)(D + step) * ws * sizeof(float2) +
         (size_t)kWarps * step * dzst * sizeof(float) +
         (size_t)F * sizeof(float4) +
         (staged ? (size_t)gmm::stage_floats(D, F) * sizeof(float) : 0);
}
size_t row_bytes(int D) {
  return (size_t)(gmm::split_stride(D) + gmm::split_stride(D / 2)) *
         sizeof(float2);
}

template <int D, int NTW>
__global__ void __launch_bounds__(kThreads, 1)
gmm_head_bwd_kernel(const float* __restrict__ z, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ g, float* __restrict__ dz,
                    float* __restrict__ part, long long rows, int C, int F,
                    int L, bool staged) {
  constexpr int MT = step_rows(D) / 16;           // mma tiles a step
  constexpr int kRows = 16 * MT;                  // rows a step
  constexpr int zst = gmm::split_stride(D);       // float2 stride of zs
  constexpr int dzst = 2 * gmm::split_stride(D / 2);  // float stride of dz rows
  const int ws = gmm::split_stride(F);
  extern __shared__ float4 smem[];
  float2* w1s = reinterpret_cast<float2*>(smem);       // [D][ws] W1[c] split
  float2* dhs = w1s + D * ws;                          // [kRows][ws] dh split
  float2* zs = dhs + kRows * ws;                       // [L][zst] Z split
  float* dzs = reinterpret_cast<float*>(zs + L * zst); // [L][dzst] dz sums
  float* red = dzs + L * dzst;                 // [kWarps][kRows][dzst] dz parts
  float4* pk = reinterpret_cast<float4*>(red + kWarps * kRows * dzst);
  float* stage = reinterpret_cast<float*>(pk + F);     // W1c, b1c, W2c

  const int warp = threadIdx.x >> 5, gq = gmm::lane_g(), t = gmm::lane_t();
  const long long row0 = (long long)blockIdx.x * L;
  const int n_here = (int)min((long long)L, rows - row0);
  const int n_pad = (n_here + kRows - 1) / kRows * kRows;
  if (staged) gmm::stage_component(stage, w1, b1, w2, 0, D, F);

  for (int i = threadIdx.x; i < n_pad * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    zs[r * zst + d] =
        gmm::split_tf32(r < n_here ? __ldg(z + (row0 + r) * D + d) : 0.f);
    dzs[r * dzst + d] = 0.f;
  }

  const long long DF = (long long)D * F;
  float* p_dw1 = part + (long long)blockIdx.x * per_cta(D, C, F);
  float* p_db1 = p_dw1 + C * DF;
  float* p_dw2 = p_db1 + (long long)C * F;
  float* p_db2 = p_dw2 + (long long)C * F * 3;

  // g of this thread's rows of the step at s0: tile m, half h -> row
  // s0 + 16m + gq + 8h (zero past the range)
  auto load_g = [&](int s0, int c, float (&gv)[MT][2][3]) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = s0 + 16 * m + gq + 8 * h;
        const float* gr = g + ((row0 + r) * C + c) * 3;
#pragma unroll
        for (int o = 0; o < 3; ++o)
          gv[m][h][o] = r < n_here ? __ldg(gr + o) : 0.f;
      }
    }
  };

  float gn[MT][2][3];  // g of the next step, loaded a step ahead
  load_g(0, 0, gn);
  for (int c = 0; c < C; ++c) {
    if (staged) gmm::cp_async_wait_all();
    __syncthreads();  // stage holds c; every warp is done with c - 1
    if (staged)
      gmm::unpack_component(w1s, ws, pk, stage, stage + D * F,
                            stage + D * F + F, D, F);
    else
      gmm::unpack_component(w1s, ws, pk, w1 + c * DF, b1 + (size_t)c * F,
                            w2 + (size_t)c * F * 3, D, F);
    __syncthreads();
    if (staged && c + 1 < C)
      gmm::stage_component(stage, w1, b1, w2, c + 1, D, F);

    // dW1[c][d, f] on the mma fragment, as two chains: awh + awx
    float awh[D / 16][NTW][4] = {}, awx[D / 16][NTW][4] = {};
    float a2[NTW][2][3] = {};         // dW2[c][f, :] for columns 2t, 2t+1
    float ab1[NTW][2] = {};           // db1[c][f]
    float ab2[3] = {};                // db2[c] (warp 0, t = 0 lanes)

    for (int s0 = 0; s0 < n_here; s0 += kRows) {
      float gv[MT][2][3];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int o = 0; o < 3; ++o) gv[m][h][o] = gn[m][h][o];
      if (s0 + kRows < n_here)
        load_g(s0 + kRows, c, gn);
      else if (c + 1 < C)
        load_g(0, c + 1, gn);  // the next component's first step
      if (warp == 0 && t == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int o = 0; o < 3; ++o) ab2[o] += gv[m][h][o];
      }

      // Per 8-column tile of this warp: pre (the forward's pre_tile), h and
      // dh on the accumulator fragment, dW2 and db1 in registers, dh split
      // into shared memory for the dW1 product, and dz's part over these
      // columns: the fragment is the A operand of dh . W1[c]^T when the k
      // index of the 8 columns runs 2t -> t, 2t+1 -> t+4.
      gmm::FragA a[MT][D / 8];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks)
          a[m][ks] = gmm::load_a(zs + (s0 + 16 * m) * zst + 8 * ks, zst, 1);
      float adz[MT][D / 8][4] = {};
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        // a column tile past F (F < 64 NTW) computes on tile 0 and adds
        // nothing, so the code has no branch and the tiles overlap
        const bool live = 8 * (warp + kWarps * j) < F;
        const int col0 = live ? 8 * (warp + kWarps * j) : 0;
        gmm::FragB b[D / 8];
        gmm::load_w1<D>(b, w1s, ws, col0);
        const float4 p[2] = {pk[col0 + 2 * t], pk[col0 + 2 * t + 1]};
        float acc[MT][4];
        gmm::pre_tile<D, MT>(acc, a, b, p[0].x, p[1].x);
        gmm::FragA ah[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float dh[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i >> 1, k = i & 1;
            const float* gg = gv[m][h];
            const float x = live ? fmaxf(acc[m][i], 0.f) : 0.f;
#pragma unroll
            for (int o = 0; o < 3; ++o)
              a2[j][k][o] = fmaf(x, gg[o], a2[j][k][o]);
            float gw = gg[0] * p[k].y;
            gw = fmaf(gg[1], p[k].z, gw);
            gw = fmaf(gg[2], p[k].w, gw);
            dh[i] = live && acc[m][i] > 0.f ? gw : 0.f;
            ab1[j][k] += dh[i];
          }
          float2 v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = gmm::split_tf32(dh[i]);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (live)
              *reinterpret_cast<float4*>(
                  dhs + (16 * m + gq + 8 * h) * ws + col0 + 2 * t) =
                  make_float4(v[2 * h].x, v[2 * h].y, v[2 * h + 1].x,
                              v[2 * h + 1].y);
          ah[m] = gmm::a_from_acc(v);
        }
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const gmm::FragB bw = gmm::load_w1t(w1s, ws, 8 * dn, col0);
#pragma unroll
          for (int m = 0; m < MT; ++m) gmm::mma3(adz[m][dn], ah[m], bw);
        }
      }
      // this warp's part of dz over its columns
      float* mine = red + warp * kRows * dzst;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(mine + (16 * m + gq + 8 * h) * dzst +
                                       8 * dn + 2 * t) =
                make_float2(adz[m][dn][2 * h], adz[m][dn][2 * h + 1]);
      __syncthreads();  // dh and the dz parts of the step are complete

      // dz[step rows] += the warps' parts, in warp order
      for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
        const int r = e / D, d = e - r * D;
        float sum = dzs[(s0 + r) * dzst + d];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[(w * kRows + r) * dzst + d];
        dzs[(s0 + r) * dzst + d] = sum;
      }

      // dW1[c][:, this warp's columns] += Z^T . dh over the step's rows
#pragma unroll
      for (int kk = 0; kk < kRows / 8; ++kk) {
        gmm::FragB b[NTW];
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          // past F: tile 0 again, into sums that are never written
          const int col0 = 8 * (warp + kWarps * j);
          b[j] = gmm::load_b(dhs + 8 * kk * ws + (col0 < F ? col0 : 0), ws, 1);
        }
#pragma unroll
        for (int mi = 0; mi < D / 16; ++mi) {
          const gmm::FragA az =
              gmm::load_a(zs + (s0 + 8 * kk) * zst + 16 * mi, 1, zst);
#pragma unroll
          for (int j = 0; j < NTW; ++j)
            gmm::mma3_split(awh[mi][j], awx[mi][j], az, b[j]);
        }
      }
      __syncthreads();  // dh and the parts are free for the next step
    }

    // component c's partial sums, written once
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col0 = 8 * (warp + kWarps * j);
      if (col0 >= F) continue;
      const int f = col0 + 2 * t;
#pragma unroll
      for (int mi = 0; mi < D / 16; ++mi) {
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = awh[mi][j][i] + awx[mi][j][i];
        float* dst = p_dw1 + c * DF + (long long)(16 * mi + gq) * F + f;
        *reinterpret_cast<float2*>(dst) = make_float2(w[0], w[1]);
        *reinterpret_cast<float2*>(dst + 8 * F) = make_float2(w[2], w[3]);
      }
      // sum over the 8 lanes that share t (rows gq), in a fixed tree
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
#pragma unroll
          for (int o = 0; o < 3; ++o)
            a2[j][k][o] += __shfl_xor_sync(0xffffffffu, a2[j][k][o], sh);
          ab1[j][k] += __shfl_xor_sync(0xffffffffu, ab1[j][k], sh);
        }
        if (gq == 0) {
          float* d2 = p_dw2 + ((long long)c * F + f + k) * 3;
          d2[0] = a2[j][k][0];
          d2[1] = a2[j][k][1];
          d2[2] = a2[j][k][2];
          p_db1[(long long)c * F + f + k] = ab1[j][k];
        }
      }
    }
    if (warp == 0) {
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1)
#pragma unroll
        for (int o = 0; o < 3; ++o)
          ab2[o] += __shfl_xor_sync(0xffffffffu, ab2[o], sh);
      if (threadIdx.x == 0) {
        p_db2[c * 3 + 0] = ab2[0];
        p_db2[c * 3 + 1] = ab2[1];
        p_db2[c * 3 + 2] = ab2[2];
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < n_here * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dz[(row0 + r) * D + d] = dzs[r * dzst + d];
  }
}

// out[i] = sum over CTAs b = 0, 1, ... of part[b * stride + i], in that
// order.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, long long n,
                                    long long stride, int n_ctas) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 16
  for (int b = 0; b < n_ctas; ++b) s += part[(long long)b * stride + i];
  out[i] = s;
}

// The grid of one call: CTAs, rows a CTA, whether the weights are staged.
struct Grid {
  int ctas, L;
  bool staged;
  size_t smem;
};

cudaError_t plan_grid(long long rows, int D, int F, Grid* grid,
                      gmm::DeviceInfo* info) {
  cudaError_t e = gmm::device_info(info);
  if (e != cudaSuccess) return e;
  const size_t cap = (size_t)info->max_smem;
  const int step = step_rows(D);   // a range is whole steps
  auto most_rows = [&](bool staged) -> long long {
    const size_t fixed = fixed_bytes(D, F, staged);
    if (fixed >= cap) return 0;
    return (long long)((cap - fixed) / row_bytes(D)) / step * step;
  };
  grid->staged = most_rows(true) >= step;
  const long long lmax = most_rows(grid->staged);
  if (lmax < step) return cudaErrorInvalidValue;
  // as few waves of one CTA an SM as the rows need, rows spread evenly
  const long long sms = info->sms;
  const long long waves = (rows + sms * lmax - 1) / (sms * lmax);
  const long long per = (rows + waves * sms - 1) / (waves * sms);
  grid->L = (int)((per + step - 1) / step * step);
  grid->ctas = (int)((rows + grid->L - 1) / grid->L);
  grid->smem = fixed_bytes(D, F, grid->staged) + grid->L * row_bytes(D);
  return cudaSuccess;
}

template <int D, int NTW>
cudaError_t launch(const float* z, const float* w1, const float* b1,
                   const float* w2, const float* g, float* dz, float* part,
                   float* grads, long long rows, int C, int F,
                   cudaStream_t stream) {
  static int granted[gmm::kMaxDevices] = {};
  Grid grid;
  gmm::DeviceInfo info;
  cudaError_t e = plan_grid(rows, D, F, &grid, &info);
  if (e != cudaSuccess) return e;
  e = gmm::allow_smem((const void*)gmm_head_bwd_kernel<D, NTW>, grid.smem,
                      info.dev, granted);
  if (e != cudaSuccess) return e;
  gmm_head_bwd_kernel<D, NTW><<<grid.ctas, kThreads, grid.smem, stream>>>(
      z, w1, b1, w2, g, dz, part, rows, C, F, grid.L, grid.staged);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = grad_floats(D, C, F);
  const int threads = 256;
  sum_partials_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        stream>>>(part, grads, n, per_cta(D, C, F),
                                  grid.ctas);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const float* z, const float* w1, const float* b1,
                     const float* w2, const float* g, float* dz, float* part,
                     float* grads, long long rows, int C, int F,
                     cudaStream_t s) {
  if (F <= 8 * kWarps)
    return launch<D, 1>(z, w1, b1, w2, g, dz, part, grads, rows, C, F, s);
  if (F <= 16 * kWarps)
    return launch<D, 2>(z, w1, b1, w2, g, dz, part, grads, rows, C, F, s);
  return launch<D, 4>(z, w1, b1, w2, g, dz, part, grads, rows, C, F, s);
}

// -- the wide form (gmm_tiled.cuh; see the note at the top) -----------------

// 1: dh of component c into dh [rows, F], and per row tile the partial sums
// part[tile][f] = (dW2[c][f, 0..2], db1[c][f]) and, from the CTAs of the
// first F chunk, part_b2[tile] = the sums of g[:, c, 0..2].
__global__ void __launch_bounds__(gmm::tiled::kThreads, 2)
gmm_bwd_dh_kernel(const float* __restrict__ z, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ g, float* __restrict__ dh,
                  float4* __restrict__ part, float4* __restrict__ part_b2,
                  long long rows, int D, int C, int F, int c) {
  using namespace gmm::tiled;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int gq = gmm::lane_g();
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const float* b1c = b1 + (size_t)c * F;
  const float* w2c = w2 + (size_t)c * F * 3;
  Acc acc;
  mainloop<kMK, kKN>(acc, z, D, w1 + (size_t)c * D * F, F, m0, n0, rows, D,
                     smem);
  float gv[kMT][2][3];  // g of the thread's rows (zero past the end)
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = m0 + acc_row(mt, 2 * h);
#pragma unroll
      for (int o = 0; o < 3; ++o)
        gv[mt][h][o] = r < rows ? __ldg(g + (r * C + c) * 3 + o) : 0.f;
    }
  float* red = smem;  // [4 warps along M][kBN][4]
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = acc_col(nt, j), f = n0 + col;
      const float bias = __ldg(b1c + f);
      const float v0 = __ldg(w2c + 3 * f), v1 = __ldg(w2c + 3 * f + 1),
                  v2 = __ldg(w2c + 3 * f + 2);
      float s[4] = {0.f, 0.f, 0.f, 0.f};  // dW2[f, 0..2], db1[f]
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* gg = gv[mt][h];
          const float pre = acc.v[mt][nt][2 * h + j] + bias;
          const float x = fmaxf(pre, 0.f);
          s[0] = fmaf(x, gg[0], s[0]);
          s[1] = fmaf(x, gg[1], s[1]);
          s[2] = fmaf(x, gg[2], s[2]);
          float gw = gg[0] * v0;
          gw = fmaf(gg[1], v1, gw);
          gw = fmaf(gg[2], v2, gw);
          const float d = pre > 0.f ? gw : 0.f;
          s[3] += d;
          acc.v[mt][nt][2 * h + j] = d;
        }
      // over the 8 lanes that share t (the warp's rows), in a fixed tree
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1)
          s[q] += __shfl_xor_sync(0xffffffffu, s[q], sh);
      }
      if (gq == 0)
        *reinterpret_cast<float4*>(red + (warp_m() * kBN + col) * 4) =
            make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  // dh of the tile, two columns a store
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = m0 + acc_row(mt, 2 * h);
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<float2*>(dh + r * F + n0 + acc_col(nt, 0)) =
            make_float2(acc.v[mt][nt][2 * h], acc.v[mt][nt][2 * h + 1]);
    }
  __syncthreads();
  const float4* red4 = reinterpret_cast<const float4*>(red);
  for (int col = threadIdx.x; col < kBN; col += kThreads) {
    float4 a = red4[col];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      const float4 b = red4[w * kBN + col];
      a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
    part[(long long)blockIdx.x * F + n0 + col] = a;
  }
  if (blockIdx.y == 0 && threadIdx.x < 3) {
    float sum = 0.f;  // g over the tile's rows, in order
    for (int i = 0; i < kBM && m0 + i < rows; ++i)
      sum += __ldg(g + ((m0 + i) * C + c) * 3 + threadIdx.x);
    reinterpret_cast<float*>(part_b2 + blockIdx.x)[threadIdx.x] = sum;
  }
}

// 2: dW2[c], db1[c] and db2[c] from the row tiles' partials, summed over
// the tiles in order, into grads = [dW1 | db1 | dW2 | db2]
__global__ void gmm_bwd_sum_kernel(const float4* __restrict__ part,
                                   const float4* __restrict__ part_b2,
                                   float* __restrict__ grads, int tiles,
                                   int D, int C, int F, int c) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f > F) return;
  const float4* src = f < F ? part + f : part_b2;
  const long long stride = f < F ? F : 1;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < tiles; ++i) {
    const float4 b = src[i * stride];
    a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  float* db1 = grads + (long long)C * D * F;
  float* dw2 = db1 + (long long)C * F;
  float* db2 = dw2 + (long long)C * F * 3;
  float* d = f < F ? dw2 + ((long long)c * F + f) * 3 : db2 + 3 * c;
  d[0] = a.x;
  d[1] = a.y;
  d[2] = a.z;
  if (f < F) db1[(long long)c * F + f] = a.w;
}

// 3: dz[:, d tile] = (c > 0 ? dz : 0) + dh . W1[c]^T
__global__ void __launch_bounds__(gmm::tiled::kThreads, 2)
gmm_bwd_dz_kernel(const float* __restrict__ dh, const float* __restrict__ w1,
                  float* __restrict__ dz, long long rows, int D, int F,
                  int c) {
  using namespace gmm::tiled;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  Acc acc;
  mainloop<kMK, kNK>(acc, dh, F, w1 + (size_t)c * D * F, F, m0, n0, rows, F,
                     smem);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = m0 + acc_row(mt, 2 * h);
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float2* dst =
            reinterpret_cast<float2*>(dz + r * D + n0 + acc_col(nt, 0));
        float2 v = make_float2(acc.v[mt][nt][2 * h], acc.v[mt][nt][2 * h + 1]);
        if (c > 0) {
          const float2 prev = *dst;
          v = make_float2(prev.x + v.x, prev.y + v.y);
        }
        *dst = v;
      }
    }
}

// 4: dW1[c][d tile, f tile] = Z^T . dh over every row
__global__ void __launch_bounds__(gmm::tiled::kThreads, 2)
gmm_bwd_dw1_kernel(const float* __restrict__ z, const float* __restrict__ dh,
                   float* __restrict__ grads, long long rows, int D, int F,
                   int c) {
  using namespace gmm::tiled;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  Acc acc;
  mainloop<kKM, kKN>(acc, z, D, dh, F, m0, n0, D, rows, smem);
  float* dw1 = grads + (size_t)c * D * F;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = m0 + acc_row(mt, 2 * h);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<float2*>(dw1 + (size_t)d * F + n0 +
                                   acc_col(nt, 0)) =
            make_float2(acc.v[mt][nt][2 * h], acc.v[mt][nt][2 * h + 1]);
    }
}

// floats of the wide form's scratch: dh [rows, F], then the partials
// [tiles, F] and [tiles] float4
long long tiled_scratch(long long rows, int F) {
  const long long tiles = (rows + gmm::tiled::kBM - 1) / gmm::tiled::kBM;
  return rows * F + tiles * 4LL * (F + 1);
}

cudaError_t launch_tiled(const float* z, const float* w1, const float* b1,
                         const float* w2, const float* g, float* dz,
                         float* scratch, float* grads, long long rows, int D,
                         int C, int F, cudaStream_t stream) {
  using namespace gmm::tiled;
  static int granted[3][gmm::kMaxDevices] = {};
  gmm::DeviceInfo info;
  cudaError_t e = gmm::device_info(&info);
  if (e != cudaSuccess) return e;
  const size_t smem_fwd = Gemm<kMK, kKN>::SMEM, smem_dz = Gemm<kMK, kNK>::SMEM,
               smem_dw1 = Gemm<kKM, kKN>::SMEM;
  e = gmm::allow_smem((const void*)gmm_bwd_dh_kernel, smem_fwd, info.dev,
                      granted[0]);
  if (e == cudaSuccess)
    e = gmm::allow_smem((const void*)gmm_bwd_dz_kernel, smem_dz, info.dev,
                        granted[1]);
  if (e == cudaSuccess)
    e = gmm::allow_smem((const void*)gmm_bwd_dw1_kernel, smem_dw1, info.dev,
                        granted[2]);
  if (e != cudaSuccess) return e;
  const long long tiles = (rows + kBM - 1) / kBM;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  float* dh = scratch;
  float4* part = reinterpret_cast<float4*>(scratch + rows * F);
  float4* part_b2 = part + tiles * F;
  const int sum_threads = 128;
  for (int c = 0; c < C; ++c) {
    gmm_bwd_dh_kernel<<<dim3((unsigned)tiles, F / kBN), kThreads, smem_fwd,
                        stream>>>(z, w1, b1, w2, g, dh, part, part_b2, rows,
                                  D, C, F, c);
    gmm_bwd_sum_kernel<<<(F + sum_threads) / sum_threads, sum_threads, 0,
                         stream>>>(part, part_b2, grads, (int)tiles, D, C, F,
                                   c);
    gmm_bwd_dz_kernel<<<dim3((unsigned)tiles, D / kBN), kThreads, smem_dz,
                        stream>>>(dh, w1, dz, rows, D, F, c);
    gmm_bwd_dw1_kernel<<<dim3(D / kBM, F / kBN), kThreads, smem_dw1,
                         stream>>>(z, dh, grads, rows, D, F, c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Floats of scratch a call with these widths and this many rows needs on
// the current device: the narrow kernel's per-CTA partial copies of the
// weight gradients (plan_grid's CTAs, C*(D*F + 4F + 3) floats each,
// rounded up to a multiple of 4), or the wide form's dh and row-tile
// partials.  0 for no rows; a negative cudaError_t on error.
extern "C" long long gmm_head_bwd_scratch(long long rows, int D, int C,
                                          int F) {
  if (rows <= 0) return 0;
  if (!gmm::narrow_takes(D, F))
    return gmm::tiled::takes(D, F) ? tiled_scratch(rows, F)
                                   : -(long long)cudaErrorInvalidValue;
  Grid grid;
  gmm::DeviceInfo info;
  const cudaError_t e = plan_grid(rows, D, F, &grid, &info);
  return e == cudaSuccess ? (long long)grid.ctas * per_cta(D, C, F)
                          : -(long long)e;
}

// Plain C interface for ctypes.  All pointers are device pointers to
// contiguous float32 arrays; z, dz, w1, b1, w2 and part must be 16-byte
// aligned.  The widths: D in {16, 32, 64} with F a multiple of 8 up to
// gmm::kMaxF (the narrow kernel), or D and F multiples of 128 (the wide
// form).  part holds gmm_head_bwd_scratch(rows, D, C, F) floats.  grads
// receives [dW1 (C*D*F) | db1 (C*F) | dW2 (C*F*3) | db2 (C*3)].  Returns
// the cudaError_t of the launches (0 = launched).
extern "C" int gmm_head_bwd(const void* z, const void* w1, const void* b1,
                            const void* w2, const void* g, void* dz,
                            void* part, void* grads, long long rows, int D,
                            int C, int F, void* stream) {
  if (rows <= 0) return 0;
  const bool narrow = gmm::narrow_takes(D, F);
  if (!narrow && !gmm::tiled::takes(D, F)) return (int)cudaErrorInvalidValue;
  const float* zf = static_cast<const float*>(z);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* gf = static_cast<const float*>(g);
  float* dzf = static_cast<float*>(dz);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(grads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!narrow)
    return (int)launch_tiled(zf, w1f, b1f, w2f, gf, dzf, pf, of, rows, D, C,
                             F, s);
  switch (D) {
    case 16:
      return launch_d<16>(zf, w1f, b1f, w2f, gf, dzf, pf, of, rows, C, F, s);
    case 32:
      return launch_d<32>(zf, w1f, b1f, w2f, gf, dzf, pf, of, rows, C, F, s);
    case 64:
      return launch_d<64>(zf, w1f, b1f, w2f, gf, dzf, pf, of, rows, C, F, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
