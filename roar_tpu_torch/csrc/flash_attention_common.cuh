// What the flash-attention forward and backward kernels share: the element
// types they take in device memory and how a tile reaches shared memory in
// the fp32 kernels.
//
// Types.  q, k, v, o, dO, dq, dk, dv are fp32 or bf16 in device memory; every
// product accumulates in fp32, and lse and delta are always fp32.  The fp32
// forward runs on the FMA pipe (this header's `load_tile` stages its tiles in
// shared memory); the fp32 dK/dV and dQ kernels multiply on the tensor cores
// in 3xTF32 (tf32x3.cuh); every bf16 kernel, the forward, dK/dV and dQ, keeps
// its tiles in bf16 and multiplies on the tensor cores
// (flash_attention_mma.cuh).  A bf16
// kernel rounds to bf16 at exactly these places (the upstream Pallas kernels
// round at the same ones, casting to the other operand's type before each of
// the products named), as it packs its A fragments or stores:
//   forward:   p = exp(s - m) before p.v (its row sum is taken unrounded),
//              and o as it is stored;
//   backward:  p = exp(s - lse) before p^T dO; dS (from the unrounded p)
//              before dS^T q and dS k; dq, dk, dv as they are stored.
//
// Causal masking.  With `causal`, query i also sees key j only when j <= i.
// The query and key tiles are both 64 wide, so a key tile lies wholly above
// the diagonal exactly when its first key comes after the query tile's last
// row: such tiles are skipped unloaded by the loop bounds, and the diagonal
// tile is masked element by element.

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr int TILE = 64;      // query rows and keys per tile
constexpr int THREADS = 256;  // 16 x 16

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// rows r0 .. r0+63 of x[b, :, h, :] into dst[TILE][STRIDE]; rows past T are
// zeros
template <int D, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ x, long base,
                                          long ld, int r0, int T, int tid) {
  constexpr int PER_ROW = D / 4;  // 16-byte loads
  for (int i = tid; i < TILE * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) val = *reinterpret_cast<const float4*>(x + base + (long)(r0 + r) * ld + c);
    float* d = dst + r * STRIDE + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

inline bool bad_shape(int B, int T, int H) {
  return B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace flash
