// The building blocks of the fp32 flash-attention kernels on the tensor
// cores in 3xTF32 (tf32x3.cuh): the forward (flash_attention_fwd.cu) and the
// dK/dV and dQ kernels (flash_attention_bwd.cu).
//
// Tiles are fp32 [64][D + 4] words in shared memory, staged by 16-byte
// cp.async.  A row stride of 4 (mod 32) banks puts the 8 row addresses of each
// ldmatrix in 8 different 16-byte bank groups, and the 32 words of a `load_bt`
// read (rows 2t, column g) in 32 banks.  A tile that all four warps read as a
// B operand is split once in shared memory into a big and a small half (TF32
// bit patterns, by integer operations: `split_tf32_int`, the bits of
// `cvt.rna`).
//
// An m16n8k8 C fragment (c0, c1 at (g, 2t..2t+1)) is not its A fragment (a0 at
// (g, t), a2 at (g, t+4)), so a product whose A operand is a score tile's
// accumulator permutes its contraction index within each k-chunk of 8: A's
// column t is C's column 2t and A's column t + 4 is C's column 2t + 1
// (`acc_as_a`), and the B operand's rows are read with the same permutation,
// rows 2t and 2t + 1 (`load_bt`).  No shuffle, and the probabilities and dS
// never pass through shared memory.

#pragma once

#include <cstdint>

#include "flash_attention_mma.cuh"
#include "tf32x3.cuh"

namespace flash {
namespace tf32 {

using tf32x3::mma_3xtf32;
using tf32x3::split_tf32_int;

// rows r0 .. r0+R-1 of x[b, :, h, :] (row t at base + t * ld) into an fp32
// tile of row stride D + 4 by 16-byte cp.async, by a block of NTHREADS; rows
// past T are zero-filled
template <int D, int R = mma::ROWS, int NTHREADS = mma::THREADS>
__device__ __forceinline__ void stage_tile_f32(float* dst, const float* __restrict__ x,
                                               long base, long ld, int r0, int T, int tid) {
  constexpr int CHUNKS = D / 4;
#pragma unroll
  for (int j = 0; j < R * CHUNKS / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool in = r0 + r < T;
    mma::cp_async16(dst + r * (D + 4) + c * 4, x + base + (long)(in ? r0 + r : 0) * ld + c * 4,
                    in);
  }
}

// every word v of a staged R-row tile replaced by its big half tf32(v), and
// written to the same place of `small`: its small half tf32(v - big), or with
// `REST` the whole rest v - big, unrounded (for `split_rest`); by a block of
// NTHREADS, each thread the words `stage_tile_f32` copies for it
template <int D, bool REST = false, int R = mma::ROWS, int NTHREADS = mma::THREADS>
__device__ __forceinline__ void split_tile_f32(float* big, float* small, int tid) {
  constexpr int CHUNKS = D / 4;
#pragma unroll
  for (int j = 0; j < R * CHUNKS / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int at = (i / CHUNKS) * (D + 4) + (i % CHUNKS) * 4;
    const float4 v = *reinterpret_cast<const float4*>(big + at);
    uint4 hi, lo;
    if (REST) {
      hi = make_uint4(tf32x3::tf32_int(v.x), tf32x3::tf32_int(v.y), tf32x3::tf32_int(v.z),
                      tf32x3::tf32_int(v.w));
      lo = make_uint4(__float_as_uint(v.x - __uint_as_float(hi.x)),
                      __float_as_uint(v.y - __uint_as_float(hi.y)),
                      __float_as_uint(v.z - __uint_as_float(hi.z)),
                      __float_as_uint(v.w - __uint_as_float(hi.w)));
    } else {
      split_tf32_int(v.x, hi.x, lo.x);
      split_tf32_int(v.y, hi.y, lo.y);
      split_tf32_int(v.z, hi.z, lo.z);
      split_tf32_int(v.w, hi.w, lo.w);
    }
    *reinterpret_cast<uint4*>(big + at) = hi;
    *reinterpret_cast<uint4*>(small + at) = lo;
  }
}

// The rest r = v - tf32(v) of an fp32 word (up to 13 significant bits) as
// two TF32 words: mid, r with its 13 low bits cleared, and low = r - mid
// (exact, at most 2 significant bits), so that big + mid + low == v.  A
// two-word split keeps 22 of fp32's 24 bits; this one keeps them all.
__device__ __forceinline__ void split_rest(uint32_t r, uint32_t& mid, uint32_t& low) {
  mid = r & 0xffffe000u;
  low = __float_as_uint(__uint_as_float(r) - __uint_as_float(mid));
}

// c += a . b over one k-chunk, with b split exactly (big + mid + low, each
// b0, b1): small.big, big.low, big.mid, big.big into a fresh accumulator,
// smallest first, then one round-to-nearest add.  Where a is a power of two
// (a probability of 1) the accumulator's truncating sums are exact and c
// gets a . b exactly; small.small terms (below fp32's level) are dropped.
__device__ __forceinline__ void mma_4xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b_big0,
                                           uint32_t b_big1, uint32_t b_rest0, uint32_t b_rest1) {
  uint32_t mid0, low0, mid1, low1;
  split_rest(b_rest0, mid0, low0);
  split_rest(b_rest1, mid1, low1);
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  tf32x3::mma_tf32(part, a_small, b_big0, b_big1);
  tf32x3::mma_tf32(part, a_big, low0, low1);
  tf32x3::mma_tf32(part, a_big, mid0, mid1);
  tf32x3::mma_tf32(part, a_big, b_big0, b_big1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += part[e];
}

// ldmatrix.x4 on 32-bit words: lane 4 g + t gets word t of row g of each of
// the four 8 x 4-word matrices whose row addresses lanes 8 i .. 8 i + 7 give
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  mma::ldmatrix_x4(r, reinterpret_cast<const mma::bf16*>(p));
}

// the A fragment of the 16 x 8 block at rows row0.., head-dim columns 8 kc..
// of an fp32 tile or of a split half: a0 (g, t) a1 (g+8, t) a2 (g, t+4)
// a3 (g+8, t+4)
template <int D>
__device__ __forceinline__ void load_a_f32(uint32_t (&r)[4], const float* tile, int row0, int kc,
                                           int lane) {
  ldsm_x4(r, tile + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * (D + 4) + 8 * kc +
                 4 * (lane >> 4));
}

// the same fragment of an unsplit fp32 tile, split after the load
template <int D>
__device__ __forceinline__ void load_a_split(uint32_t (&big)[4], uint32_t (&small)[4],
                                             const float* tile, int row0, int kc, int lane) {
  uint32_t r[4];
  load_a_f32<D>(r, tile, row0, kc, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32_int(__uint_as_float(r[i]), big[i], small[i]);
}

// B fragments of the two n-tiles at rows n0 .. n0+7 and n0+8 .. n0+15 of a
// split half (a row is a column n of B) over head-dim k-chunk kc: b0 (k t,
// n g) = tile[n0 + g][8 kc + t], b1 at column 8 kc + t + 4; {b0, b1} of the
// first n-tile in r[0..1], of the second in r[2..3]
template <int D>
__device__ __forceinline__ void load_b2(uint32_t (&r)[4], const float* half, int n0, int kc,
                                        int lane) {
  ldsm_x4(r, half + (n0 + (lane & 7) + 8 * (lane >> 4)) * (D + 4) + 8 * kc +
                 4 * ((lane >> 3) & 1));
}

// the B fragment of the k-chunk over rows k0 .. k0+7 of a split half (rows
// are k, head-dim columns 8 j .. 8 j + 7 are n) in the permuted contraction
// order: b0 (k t, n g) = half[k0 + 2t][8 j + g], b1 (k t+4, n g) =
// half[k0 + 2t + 1][8 j + g]
template <int D>
__device__ __forceinline__ void load_bt(uint32_t (&r)[2], const float* half, int k0, int j, int g,
                                        int t) {
  const float* p = half + (k0 + 2 * t) * (D + 4) + 8 * j + g;
  r[0] = __float_as_uint(p[0]);
  r[1] = __float_as_uint(p[D + 4]);
}

// load_b2 and load_bt of an unsplit fp32 tile, each word split after the load
template <int D>
__device__ __forceinline__ void load_b2_split(uint32_t (&big)[4], uint32_t (&small)[4],
                                              const float* tile, int n0, int kc, int lane) {
  uint32_t r[4];
  load_b2<D>(r, tile, n0, kc, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32_int(__uint_as_float(r[i]), big[i], small[i]);
}

template <int D>
__device__ __forceinline__ void load_bt_split(uint32_t (&big)[2], uint32_t (&small)[2],
                                              const float* tile, int k0, int j, int g, int t) {
  uint32_t r[2];
  load_bt<D>(r, tile, k0, j, g, t);
  split_tf32_int(__uint_as_float(r[0]), big[0], small[0]);
  split_tf32_int(__uint_as_float(r[1]), big[1], small[1]);
}

// load_bt of an unsplit fp32 tile as the big half and the whole rest v - big,
// unrounded (`split_tile_f32<D, true>`'s bits), for `mma_4xtf32`
template <int D>
__device__ __forceinline__ void load_bt_rest(uint32_t (&big)[2], uint32_t (&rest)[2],
                                             const float* tile, int k0, int j, int g, int t) {
  uint32_t r[2];
  load_bt<D>(r, tile, k0, j, g, t);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    big[i] = tf32x3::tf32_int(__uint_as_float(r[i]));
    rest[i] = __float_as_uint(__uint_as_float(r[i]) - __uint_as_float(big[i]));
  }
}

// named barrier `id` (1..) over `threads` threads of the block: the warps
// that share a score tile (the split kernels) or hand one across (the bf16
// wgmma backward), and the two warpgroups that take turns (the bf16 wgmma
// forward at D 128)
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// this thread's arrival on named barrier `id`, without waiting
__device__ __forceinline__ void group_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the accumulator of one 8-wide n-tile (c0, c1 at (g, 2t..2t+1), c2, c3 at
// (g+8, 2t..2t+1)) as the split A fragment of the k-chunk over those 8
// columns, permuted as `load_bt` reads B: A's column t is C's column 2t, A's
// column t + 4 is C's column 2t + 1
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split_tf32_int(c[0], big[0], small[0]);  // (g, 2t)
  split_tf32_int(c[2], big[1], small[1]);  // (g+8, 2t)
  split_tf32_int(c[1], big[2], small[2]);  // (g, 2t+1)
  split_tf32_int(c[3], big[3], small[3]);  // (g+8, 2t+1)
}

}  // namespace tf32
}  // namespace flash
