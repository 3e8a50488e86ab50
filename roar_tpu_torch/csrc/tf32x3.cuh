// 3xTF32: fp32 products at fp32's level on the tensor cores, from TF32
// `mma.sync.m16n8k8` with fp32 sums.  Shared by the grouped-conv kernels K3
// and K4 (grouped_conv.cu) and the fp32 flash-attention kernels, forward,
// dK/dV and dQ (flash_attention_{fwd,bwd}.cu, through
// flash_attention_tf32.cuh).
//
// One TF32 product keeps 10 mantissa bits of each operand, about 3e-4 of the
// result's scale, over the fp32 bars of those kernels.  So every fp32 operand
// v is split into big = tf32(v) and small = tf32(v - big) (`cvt.rna`), and
// each k-chunk of 8 adds small.big, big.small, then big.big (small.small is
// below fp32's level).  The tensor cores' accumulator rounds toward zero:
// carried over a long contraction it drifts one way, to about 2.4e-5 of the
// scale at 2624 products on an H100.  So `mma_3xtf32` puts each k-chunk's
// three products into a fresh accumulator and adds that to the caller's sum
// with one fp32 add, rounded to nearest: the truncation touches 24 products
// at a time.
//
// Fragments of m16n8k8 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A, 16 x 8 row-major:  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B, 8 x 8 "col":       b0 (k t, n g)  b1 (k t+4, n g)
//   C, 16 x 8 fp32:       c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)

#pragma once

#include <cstdint>

namespace tf32x3 {

// fp32 -> TF32 (as a 32-bit pattern): nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32(v);
  small = tf32(v - __uint_as_float(big));
}

// The same rounding by integer operations: adding half a TF32 step to the
// magnitude's bits and clearing the 13 dropped ones gives `tf32`'s bits for
// every finite v.  `cvt` runs on a slower pipe: in the flash-attention
// backward, where every product splits two or more operand words, the
// integer form measured 12 to 14 % faster on an H100 with the same bits.
// K4 uses it too; K3 keeps `cvt` (its SASS as it was measured).
__device__ __forceinline__ uint32_t tf32_int(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32_int(float v, uint32_t& big, uint32_t& small) {
  big = tf32_int(v);
  small = tf32_int(v - __uint_as_float(big));
}

// c += a . b on the tensor cores, m16n8k8, TF32 in, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b over one k-chunk in 3xTF32, from the split fragments of a and
// of b (b0, b1 of each half): small.big, big.small, big.big into a fresh
// accumulator, then one round-to-nearest add per element
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b_big0,
                                           uint32_t b_big1, uint32_t b_small0,
                                           uint32_t b_small1) {
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(part, a_small, b_big0, b_big1);
  mma_tf32(part, a_big, b_small0, b_small1);
  mma_tf32(part, a_big, b_big0, b_big1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += part[e];
}

}  // namespace tf32x3
