#!/usr/bin/env python3
"""Measure the rate of TF32 `mma.sync.m16n8k8` (fp32 sums) on the card, the
product every fp32 kernel of the port forms its 3xTF32 sums from.

    python3 scripts/mma_tf32_rate_torch.py [--iters N]

Builds a small CUDA source with `nvcc` for `sm_90a` into
`roar_tpu_torch/build/` (git-ignored) and times, by CUDA events (median of
5 launches after one warm-up), kernels that do nothing but such products on
register operands, over one block a SM of `warps` warps:
  - `independent`: each warp adds one product into each of 8 accumulators
    per step, no product waiting on another within a step: the pipe's rate;
  - `flushed3`: per step, 4 chains of three products into a fresh
    accumulator (small.big, big.small, big.big) and 4 fp32 adds of it into a
    sum: the order of a score tile's k-chunk in the fp32 flash kernels
    (`mma_3xtf32`, csrc/tf32x3.cuh);
  - `flushed4`: per step, 8 chains of four products and their adds
    (`mma_4xtf32`, P V of the fp32 forward).
One JSON line: TFLOP/s of each (2048 operations a product), with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// KIND 0: 8 independent accumulators; 1: 4 chains of 3 into a fresh
// accumulator, flushed; 2: 8 chains of 4, flushed
template <int KIND>
__global__ void rate_kernel(float* out, int iters) {
  constexpr int N = KIND == 1 ? 4 : 8;
  const uint32_t one = __float_as_uint(1.0f), tiny = __float_as_uint(1e-6f);
  const uint32_t a[4] = {one, tiny, one, tiny};
  float c[N][4] = {};
  for (int i = 0; i < iters; ++i) {
    // an operand that differs by step and by chain, so that no product into
    // a fresh accumulator is hoisted out of the loop or shared by two chains
    const uint32_t b = tiny + 16 * (i & 7);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (KIND == 0) {
        mma(c[k], a, b + k, one);
      } else {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < KIND + 2; ++t) mma(part, a, b + k, one);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[k][e] += part[e];
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) sum += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int rate_launch(int kind, float* out, int blocks, int threads, int iters) {
  if (kind == 0) rate_kernel<0><<<blocks, threads>>>(out, iters);
  if (kind == 1) rate_kernel<1><<<blocks, threads>>>(out, iters);
  if (kind == 2) rate_kernel<2><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
# products a warp forms per step
PRODUCTS = {"independent": 8, "flushed3": 12, "flushed4": 32}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=4096)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mma_tf32_rate_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from roar_tpu_torch.kernels.library import BUILD_DIR, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib_path = BUILD_DIR / "mma_tf32_rate.cu", BUILD_DIR / "libmma_tf32_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.rate_launch.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"card": card, "sms": sms, "iters": args.iters, "tflops": {}}
    for warps in (4, 8, 16):
        out = torch.empty(sms * warps * 32, device="cuda")
        for kind, name in enumerate(PRODUCTS):
            def launch():
                err = lib.rate_launch(kind, out.data_ptr(), sms, warps * 32, args.iters)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            launch()
            times = []
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                launch()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ops = 2048.0 * PRODUCTS[name] * args.iters * warps * sms
            result["tflops"][f"{name}_{warps}_warps"] = ops / (float(np.median(times)) * 1e-3) / 1e12
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
