#!/usr/bin/env python
"""The card's ceilings for the GMM-head kernels' two product forms.

The kernels (``aline_tpu_torch/csrc/gmm_head_{fwd,bwd}.cu``) run their
D x F products as 3xTF32 on ``mma.sync``; the first kernels ran them on
float32 FMAs.  This script builds one small program (``RATE_SRC``) that
measures, on the GPU, the TF32 ``mma.sync`` rate, the float32 FMA rate,
and the rate of the kernels' own ``gmm::pre_tile``
(``gmm_head_common.cuh``, included as it is), and prints the best of
each over its settings.

Usage:
    python scripts/measure_gmm_ceilings.py [--out chiprun_out/gmm_ceilings.json]
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# TF32 mma.sync.m16n8k8 and float32 FMA throughput from independent
# chains on every SM (4-32 warps an SM, 1-8 chains a warp), and the GMM
# kernels' own gmm::pre_tile over a 128-column W1[c] in shared memory (16
# rows a warp, or 32 sharing each B fragment); one line per setting.
RATE_SRC = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
#include "gmm_head_common.cuh"
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                 "r"(b[1]));
}
template <int CH>
__global__ void k_mma(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i));
  float d[CH][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CH; ++c) mma_tf32(d[c], a, b);
  float s = 0;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k_fma(float* out, int iters) {
  float x[8], y = threadIdx.x * 1e-3f;
  for (int i = 0; i < 8; ++i) x[i] = i;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = fmaf(x[i], y, 1.0001f);
  float s = 0;
  for (int i = 0; i < 8; ++i) s += x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int MT>
__global__ void k_pre(float* out, int iters) {
  constexpr int D = 32, F = 128, ws = gmm::split_stride(F);
  __shared__ float2 w1s[D * ws];
  __shared__ float4 pk[F];
  for (int i = threadIdx.x; i < D * ws; i += blockDim.x)
    w1s[i] = gmm::split_tf32(1e-3f * i);
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    pk[i] = make_float4(0.1f, 0.2f, 0.3f, 0.4f);
  __syncthreads();
  gmm::FragA a[MT][D / 8];
  for (int m = 0; m < MT; ++m)
    for (int ks = 0; ks < D / 8; ++ks)
      for (int i = 0; i < 4; ++i) {
        const float2 v = gmm::split_tf32(1e-2f * (threadIdx.x + i + ks + m));
        a[m][ks].hi[i] = __float_as_uint(v.x);
        a[m][ks].lo[i] = __float_as_uint(v.y);
      }
  const int t = threadIdx.x & 3;
  float o = 0.f;
  for (int it = 0; it < iters / 16; ++it)
    for (int col0 = 0; col0 < F; col0 += 8) {
      gmm::FragB b[D / 8];
      gmm::load_w1<D>(b, w1s, ws, col0);
      const float4 p = pk[col0 + 2 * t];
      float acc[MT][4];
      gmm::pre_tile<D, MT>(acc, a, b, p.x, p.y);
      for (int m = 0; m < MT; ++m)
        for (int i = 0; i < 4; ++i) o = fmaf(fmaxf(acc[m][i], 0.f), p.z, o);
    }
  out[blockIdx.x * blockDim.x + threadIdx.x] = o;
}
template <typename K>
float run(K kern, int sms, int warps, float* out, int iters) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  kern<<<sms * 4, 8 * warps>>>(out, iters);
  cudaEventRecord(e0);
  kern<<<sms * 4, 8 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, 1 << 26);
  const int iters = 4096;
  for (int warps : {4, 8, 16, 32}) {
    const double mmas = (double)sms * warps * iters;
    printf("mma_tf32 warps %d chains 1 %.1f\n", warps,
           mmas * 2048 / run(k_mma<1>, sms, warps, out, iters) / 1e9);
    printf("mma_tf32 warps %d chains 4 %.1f\n", warps,
           4 * mmas * 2048 / run(k_mma<4>, sms, warps, out, iters) / 1e9);
    printf("mma_tf32 warps %d chains 8 %.1f\n", warps,
           8 * mmas * 2048 / run(k_mma<8>, sms, warps, out, iters) / 1e9);
    printf("ffma_f32 warps %d chains 8 %.1f\n", warps,
           mmas * 32 * 256 / run(k_fma, sms, warps, out, iters) / 1e9);
    // 12 mma a 16-row tile and 8 columns: 3 per k-step of D = 32
    printf("pre_tile_16_rows warps %d %.1f\n", warps,
           mmas * 12 * 2048 / run(k_pre<1>, sms, warps, out, iters) / 1e9);
    printf("pre_tile_32_rows warps %d %.1f\n", warps,
           2 * mmas * 12 * 2048 / run(k_pre<2>, sms, warps, out, iters) / 1e9);
  }
  return cudaGetLastError() != cudaSuccess;
}
"""


def peak_rates(workdir):
    """{setting: TFLOP/s}, one entry per line the program prints."""
    from aline_tpu_torch.ops import _build
    src, exe = workdir / "rate.cu", workdir / "rate"
    src.write_text(RATE_SRC)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", f"-I{_build.CSRC_DIR}", "-o",
                    str(exe), str(src)], check=True, capture_output=True,
                   text=True)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.splitlines()
    rates = {}
    for line in lines:
        *key, value = line.split()
        rates[" ".join(key)] = float(value)
    return rates


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "gmm_ceilings.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("measure_gmm_ceilings.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="gmm_ceilings_") as work:
        rates = peak_rates(Path(work))
    best = {}
    for key in ("mma_tf32", "ffma_f32", "pre_tile_16_rows",
                "pre_tile_32_rows"):
        best[key] = max(v for k, v in rates.items() if k.startswith(key))
        print(f"{key}: at most {best[key]:.1f} TFLOP/s over the settings "
              f"({smi})", flush=True)
    result = {"nvidia_smi": smi, "best_tflops": best, "tflops": rates}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
