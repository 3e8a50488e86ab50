// What the flash-attention forward and backward kernels share: the element
// types they take in device memory, where the bf16 form rounds, and how the
// causal mask meets the tiles.
//
// Types.  q, k, v, o, dO, dq, dk, dv are fp32 or bf16 in device memory; every
// product accumulates in fp32, and lse and delta are always fp32.  Every
// kernel multiplies on the tensor cores: the fp32 forward, dK/dV and dQ
// kernels in 3xTF32 (tf32x3.cuh, flash_attention_tf32.cuh), at fp32's level;
// every bf16 kernel, the forward, dK/dV and dQ, keeps its tiles in bf16
// (flash_attention_mma.cuh; at D 256 flash_attention_wgmma.cuh).  A bf16
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

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

inline bool bad_shape(int B, int T, int H) {
  return B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace flash
