// What the flash-attention forward and backward kernels share: the element
// types they take in device memory and how a tile of them reaches shared
// memory in the FMA kernels.
//
// Types.  q, k, v, o, dO, dq, dk, dv are fp32 or bf16 in device memory; every
// product accumulates in fp32, and lse and delta are always fp32.  The FMA
// kernels (fp32, and the bf16 dq kernel) widen every tile to fp32 as they
// stage it in shared memory; the bf16 forward and dK/dV kernels keep tiles in
// bf16 and multiply on the tensor cores (flash_attention_mma.cuh).  A bf16
// kernel rounds to bf16 at exactly these places (the upstream Pallas kernels
// round at the same ones, casting to the other operand's type before each of
// the products named):
//   forward:   p = exp(s - m) before p.v (its row sum is taken unrounded),
//              and o as it is stored;
//   backward:  p = exp(s - lse) before p^T dO; dS before dS^T q and dS k;
//              dq, dk, dv as they are stored.
// `round_as<E>` is that rounding (the identity for fp32); the tensor-core
// kernels round the same values as they pack their fragments.
//
// Causal masking.  With `causal`, query i also sees key j only when j <= i.
// The query and key tiles are both 64 wide, so a key tile lies wholly above
// the diagonal exactly when its first key comes after the query tile's last
// row: such tiles are skipped unloaded by the loop bounds, and the diagonal
// tile is masked element by element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int TILE = 64;      // query rows and keys per tile
constexpr int THREADS = 256;  // 16 x 16

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename E>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_as(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// One 16-byte load widened to fp32: 4 floats or 8 bf16 values.
template <typename E>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* src, float (&x)[N]) {
    const float4 raw = *reinterpret_cast<const float4*>(src);
    x[0] = raw.x; x[1] = raw.y; x[2] = raw.z; x[3] = raw.w;
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* src, float (&x)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// rows r0 .. r0+63 of x[b, :, h, :] into dst[TILE][STRIDE] as fp32; rows past
// T are zeros
template <typename E, int D, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const E* __restrict__ x, long base,
                                          long ld, int r0, int T, int tid) {
  constexpr int N = Pack<E>::N, PER_ROW = D / N;
  for (int i = tid; i < TILE * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * N;
    float val[N];
#pragma unroll
    for (int j = 0; j < N; ++j) val[j] = 0.f;
    if (r0 + r < T) Pack<E>::load(x + base + (long)(r0 + r) * ld + c, val);
    float* d = dst + r * STRIDE + c;
#pragma unroll
    for (int j = 0; j < N; ++j) d[j] = val[j];
  }
}

inline bool bad_shape(int B, int T, int H) {
  return B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace flash
