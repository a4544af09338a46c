// Device helpers shared by the fused GMM-head kernels (gmm_head_fwd.cu,
// gmm_head_bwd.cu), narrow form: float32 products on the tensor cores as 3xTF32, and
// the pre-activation tile pre = Z . W1[c] + b1[c] that both kernels compute
// with pre_tile below, so the backward's relu mask is bitwise the forward's.
//
// 3xTF32.  TF32 keeps 10 mantissa bits, so one product on the tensor cores
// keeps about three decimal digits.  Each float32 operand x is split as
// x_hi = cvt.rna.tf32(x), x_lo = cvt.rna.tf32(x - x_hi) (x - x_hi is exact),
// and a product a.b is summed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on
// mma.sync.m16n8k8 with a float32 accumulator.  The dropped a_lo.b_lo term
// and the rounding of x_lo leave an error of about 2^-21 relative to |a||b|
// per product: float32 accuracy.  Single-pass TF32 is never used.
//
// Layouts.  An operand tile lives in shared memory as float2 (hi, lo) with
// a row stride S (in float2) of S = 4 (mod 16): every fragment load below
// (row-major or transposed) then hits 16 distinct float2 slots in each
// half-warp, so no 64-bit load has a bank conflict.
//
// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4):
//   A 16x8 (row, k):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B 8x8  (k, col):  b0 (t, g)  b1 (t+4, g)
//   C 16x8 (row, col): c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gmm {

constexpr int kMaxF = 256;            // widest hidden layer the kernels take

// the widths of the narrow kernels (the tiled ones: gmm_tiled.cuh)
__host__ __device__ inline bool narrow_takes(int D, int F) {
  return (D == 16 || D == 32 || D == 64) && F % 8 == 0 && F > 0 &&
         F <= kMaxF;
}

// float2 row stride of a split tile with n columns: >= n and = 4 (mod 16)
__host__ __device__ constexpr int split_stride(int n) {
  return n + (20 - n % 16) % 16;
}

// The products, as 3xTF32 on mma.sync
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// (hi, lo) of x, each a TF32 value held in a float
__device__ __forceinline__ float2 split_tf32(float x) {
  const float hi = __uint_as_float(to_tf32(x));
  return make_float2(hi, __uint_as_float(to_tf32(x - hi)));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A fragment of a 16x8 tile whose element (r, k) is s[r * rs + k * ks]
__device__ __forceinline__ FragA load_a(const float2* s, int rs, int ks) {
  const int g = lane_g(), t = lane_t();
  const float2 v[4] = {s[g * rs + t * ks], s[(g + 8) * rs + t * ks],
                       s[g * rs + (t + 4) * ks],
                       s[(g + 8) * rs + (t + 4) * ks]};
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a.hi[i] = __float_as_uint(v[i].x);
    a.lo[i] = __float_as_uint(v[i].y);
  }
  return a;
}

// B fragment of an 8x8 tile whose element (k, n) is s[k * ks + n * ns]
__device__ __forceinline__ FragB load_b(const float2* s, int ks, int ns) {
  const int g = lane_g(), t = lane_t();
  const float2 v0 = s[t * ks + g * ns], v1 = s[(t + 4) * ks + g * ns];
  FragB b;
  b.hi[0] = __float_as_uint(v0.x);
  b.hi[1] = __float_as_uint(v1.x);
  b.lo[0] = __float_as_uint(v0.y);
  b.lo[1] = __float_as_uint(v1.y);
  return b;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// hh += a_hi.b_hi and x += a_lo.b_hi + a_hi.b_lo: a 3xTF32 sum kept as two
// chains (its value is hh + x)
__device__ __forceinline__ void mma3_split(float (&hh)[4], float (&x)[4],
                                           const FragA& a, const FragB& b) {
  mma_tf32(x, a.lo, b.hi);
  mma_tf32(hh, a.hi, b.hi);
  mma_tf32(x, a.hi, b.lo);
}

// A fragment of rows r0 .. r0+15, columns k0 .. k0+7 of the row-major
// [rows, ld] matrix z (rows past the end read 0), split
__device__ __forceinline__ FragA load_a_global(const float* __restrict__ z,
                                               int ld, long long r0,
                                               long long rows, int k0) {
  const int g = lane_g(), t = lane_t();
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + g + 8 * (i & 1);
    const float2 v = split_tf32(
        r < rows ? __ldg(z + r * ld + k0 + t + 4 * (i >> 1)) : 0.f);
    a.hi[i] = __float_as_uint(v.x);
    a.lo[i] = __float_as_uint(v.y);
  }
  return a;
}

// The accumulator fragment of a 16x8 tile (c0..c3, split) as the A operand
// of a product over the tile's 8 columns, the k index running over the
// columns as 2t -> t, 2t+1 -> t+4: a0 (g, t) = c0, a1 (g+8, t) = c2,
// a2 (g, t+4) = c1, a3 (g+8, t+4) = c3.
__device__ __forceinline__ FragA a_from_acc(const float2 (&v)[4]) {
  const int perm[4] = {0, 2, 1, 3};
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a.hi[i] = __float_as_uint(v[perm[i]].x);
    a.lo[i] = __float_as_uint(v[perm[i]].y);
  }
  return a;
}

// The B operand that goes with a_from_acc: (k, n) = W1[c][row0 + n][col0 +
// the column of k], from the split tile w1s [D][ws]: b0 at column 2t, b1 at
// 2t + 1, side by side.
__device__ __forceinline__ FragB load_w1t(const float2* w1s, int ws, int row0,
                                          int col0) {
  const float4 w = *reinterpret_cast<const float4*>(
      w1s + (row0 + lane_g()) * ws + col0 + 2 * lane_t());
  FragB b;
  b.hi[0] = __float_as_uint(w.x);
  b.lo[0] = __float_as_uint(w.y);
  b.hi[1] = __float_as_uint(w.z);
  b.lo[1] = __float_as_uint(w.w);
  return b;
}

// B fragments of W1[c][:, col0:col0+8] (k = d) from the split tile w1s
template <int D>
__device__ __forceinline__ void load_w1(FragB (&b)[D / 8], const float2* w1s,
                                        int ws, int col0) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
    b[ks] = load_b(w1s + 8 * ks * ws + col0, ws, 1);
}

// The pre-activation of MT 16-row tiles and one 8-column tile on this
// warp's accumulator fragments:
//   pre = (b1 + sum_ks z_hi.w_hi) + sum_ks (z_lo.w_hi + z_hi.w_lo)
// with each sum over the D/8 k-steps in order, as two chains, so the
// tensor core has two products of a tile in flight.  a[m] holds tile m's
// Z rows (all D columns), b the tile's W1[c] columns (all D rows),
// bias0/bias1 b1[c] at the fragment's columns 2t and 2t+1.  Every element
// is computed alike whatever MT is and wherever the fragments came from,
// so the forward and the backward get bitwise the same pre-activations.
template <int D, int MT>
__device__ __forceinline__ void pre_tile(float (&acc)[MT][4],
                                         const FragA (&a)[MT][D / 8],
                                         const FragB (&b)[D / 8], float bias0,
                                         float bias1) {
  float x[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    acc[m][0] = acc[m][2] = bias0;
    acc[m][1] = acc[m][3] = bias1;
#pragma unroll
    for (int i = 0; i < 4; ++i) x[m][i] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
    for (int m = 0; m < MT; ++m) mma3_split(acc[m], x[m], a[m][ks], b[ks]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] += x[m][i];
}

// 16-byte async copy global -> shared (L2 only: the weights are shared by
// every CTA and stay in L2)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Floats of one component's weights as staged: W1[c] [D*F], b1[c] [F],
// W2[c] [F*3], contiguous.
__host__ __device__ constexpr int stage_floats(int D, int F) {
  return D * F + 4 * F;
}

// Start copying component c's weights into stage (F % 4 == 0 and 16-byte
// aligned w1, b1, w2: every piece is whole 16-byte chunks).
__device__ __forceinline__ void stage_component(float* stage, const float* w1,
                                                const float* b1,
                                                const float* w2, int c, int D,
                                                int F) {
  const int n1 = D * F / 4, n2 = F / 4, n3 = 3 * F / 4;
  const float4* s1 = reinterpret_cast<const float4*>(w1 + (size_t)c * D * F);
  const float4* s2 = reinterpret_cast<const float4*>(b1 + (size_t)c * F);
  const float4* s3 = reinterpret_cast<const float4*>(w2 + (size_t)c * F * 3);
  float4* d = reinterpret_cast<float4*>(stage);
  for (int i = threadIdx.x; i < n1 + n2 + n3; i += blockDim.x) {
    const float4* src = i < n1 ? s1 + i : (i < n1 + n2 ? s2 + (i - n1)
                                                       : s3 + (i - n1 - n2));
    cp_async16(d + i, src);
  }
  cp_async_commit();
}

// Lay one component's weights out for the products: W1[c] split into
// w1s [D][ws] and (b1, w2_0, w2_1, w2_2) per hidden unit into pk [F].
// w1c, b1c, w2c hold W1[c], b1[c], W2[c] (in a stage that stage_component
// filled, or in device memory), 16-byte aligned, F % 4 == 0.
__device__ __forceinline__ void unpack_component(float2* w1s, int ws,
                                                 float4* pk, const float* w1c,
                                                 const float* b1c,
                                                 const float* w2c, int D,
                                                 int F) {
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int d = threadIdx.x >> 5; d < D; d += warps) {
    const float4* src = reinterpret_cast<const float4*>(w1c + d * F);
    float4* dst = reinterpret_cast<float4*>(w1s + d * ws);
    for (int f4 = lane; f4 < F / 4; f4 += 32) {
      const float4 v = src[f4];
      const float2 s0 = split_tf32(v.x), s1 = split_tf32(v.y);
      const float2 s2 = split_tf32(v.z), s3 = split_tf32(v.w);
      dst[2 * f4] = make_float4(s0.x, s0.y, s1.x, s1.y);
      dst[2 * f4 + 1] = make_float4(s2.x, s2.y, s3.x, s3.y);
    }
  }
  for (int f = threadIdx.x; f < F; f += blockDim.x)
    pk[f] = make_float4(b1c[f], w2c[3 * f], w2c[3 * f + 1], w2c[3 * f + 2]);
}

// Host side: the current device, its SM count and the shared memory a
// block may opt into, queried once per device.
struct DeviceInfo {
  int dev, sms, max_smem;
};
constexpr int kMaxDevices = 64;

inline cudaError_t device_info(DeviceInfo* info) {
  static DeviceInfo cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& c = cache[dev];
  if (c.sms == 0) {
    e = cudaDeviceGetAttribute(&c.max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      c.sms = 0;
      return e;
    }
    c.dev = dev;
  }
  *info = c;
  return cudaSuccess;
}

// Let kernel fn take smem bytes of dynamic shared memory on device dev;
// granted[dev] remembers the most it was given there (one array per
// kernel, kept by the caller).
inline cudaError_t allow_smem(const void* fn, size_t smem, int dev,
                              int* granted) {
  if (smem <= 48 * 1024 || (int)smem <= granted[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) granted[dev] = (int)smem;
  return e;
}

}  // namespace gmm
