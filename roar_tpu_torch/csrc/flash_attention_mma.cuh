// The tensor-core building blocks of the bf16 flash-attention forward up to
// D 128 and dK/dV and dQ kernels up to D 64 (the rest run on wgmma,
// flash_attention_wgmma.cuh): `cp.async` staging of bf16 tiles into an
// XOR-swizzled shared layout, `ldmatrix` fragment loads, `mma.sync.m16n8k16`
// on bf16 with fp32 accumulation; and the warp-level segment votes that every
// flash kernel uses to decide which tiles a block loads and which it must mask.
//
// Fragments of m16n8k16 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A, 16 x 16 row-major, four bf16 pairs:
//       a0 (g, 2t..2t+1)  a1 (g+8, 2t..2t+1)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B, 16 x 8 "col" (column n contiguous in k), two bf16 pairs:
//       b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C, 16 x 8 fp32:  c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// So the accumulators of two neighbouring n-tiles (keys 16 kk .. 16 kk + 15 of
// a score tile) are, element for element, the A fragment of k-chunk kk of the
// next product: a probability tile goes from one mma to the next in registers.
//
// Shared tiles are [64 rows][D] bf16 with the 16-byte chunks of each row
// permuted (`swizzle`) so that the 8 row addresses of one `ldmatrix` matrix
// fall in 8 different bank groups.  `cp.async` writes through the same map.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace flash {
namespace mma {

constexpr int ROWS = 64;     // rows (queries or keys) of a staged tile
constexpr int WARPS = 4;     // each warp owns 16 rows of the block's own tile
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row, 16-byte chunk) in a swizzled [ROWS][D] tile.  A
// D >= 64 row spans 8 or 16 chunks: chunk c of row r goes to c ^ (r % 8).  A
// D 32 row is 4 chunks, two rows to a 128-byte line: c ^ ((r / 2) % 4).
template <int D>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  const int phys = (D >= 64) ? (chunk ^ (row & 7)) : (chunk ^ ((row >> 1) & 3));
  return row * D + phys * 8;
}

// 16 bytes from global to shared; with `valid` false the 16 bytes are zeros
// and nothing is read (the caller passes an in-bounds address all the same)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores (bf16 in, fp32 sums)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest, ties to even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16 x 16 block at rows row0.., columns 16 kc.. of a
// swizzled tile: matrix i of the x4 load is (rows +8 (i & 1), columns +8 (i / 2))
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile, int row0, int kc,
                                       int lane) {
  ldmatrix_x4(r, tile + swizzle<D>(row0 + (lane & 15), 2 * kc + (lane >> 4)));
}

// B fragments of two n-tiles (rows n0 .. n0+15 of the tile, each row one
// column of B) over k-chunk kc (tile columns 16 kc ..): {b0, b1} of the first
// n-tile in r[0..1], of the second in r[2..3]
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile, int n0, int kc,
                                       int lane) {
  ldmatrix_x4(r, tile + swizzle<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                                   2 * kc + ((lane >> 3) & 1)));
}

// B fragments of the tile read transposed: k runs over rows k0 .. k0+15, n
// over tile columns 16 np .. 16 np + 15 (two n-tiles): {b0, b1} of columns
// 16 np.. in r[0..1], of 16 np + 8.. in r[2..3]
template <int D>
__device__ __forceinline__ void load_b_trans(uint32_t (&r)[4], const bf16* tile, int k0, int np,
                                             int lane) {
  ldmatrix_x4_trans(r, tile + swizzle<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                         2 * np + (lane >> 4)));
}

// rows r0 .. r0+63 of x[b, :, h, :] (row t at base + t * ld) into a swizzled
// tile by cp.async; rows past T are zero-filled and never read
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* __restrict__ x, long base,
                                           long ld, int r0, int T, int tid) {
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int j = 0; j < ROWS * CHUNKS / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool in = r0 + r < T;
    cp_async16(dst + swizzle<D>(r, c), x + base + (long)(in ? r0 + r : 0) * ld + c * 8, in);
  }
}

// rows r0 .. r0+R-1 of an fp32 [.., T] row (lse or delta) into dst[R]; past T: 0
template <int R = ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ x, int r0, int T,
                                           int tid) {
  if (tid < R) {
    const bool in = r0 + tid < T;
    cp_async4(dst + tid, x + (in ? r0 + tid : 0), in);
  }
}

// The [min, max] segment id of the in-range rows r0 .. r0+R-1 (R 32, 64 or
// 128), computed by every warp on its own (no barrier).
template <int R = ROWS>
__device__ __forceinline__ void segment_range(const int* __restrict__ segb, int r0, int T,
                                              int lane, int& lo, int& hi) {
  int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int i = 0; i < R / 32; ++i) {
    const int r = r0 + lane + 32 * i;
    if (r < T) {
      const int s = segb[r];
      mn = min(mn, s);
      mx = max(mx, s);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, mn);
  hi = __reduce_max_sync(0xffffffffu, mx);
}

// The first tile start t0, t0 + R, ... below `end` of R-row tiles (R 16, 32
// or 64) that holds an in-range row whose segment id lies in [lo, hi] (`end`
// if none).  `uniform` says that every in-range row of that tile carries the
// id lo == hi, so that no element of it needs the segment mask.  Every warp
// computes the same answer from the same ids (a 16-row tile: lanes 0..15).
template <int R = ROWS>
__device__ __forceinline__ int next_tile(const int* __restrict__ segb, int t0, int end, int T,
                                         int lo, int hi, int lane, bool& uniform) {
  for (; t0 < end; t0 += R) {
    bool seen = false, other = false;
#pragma unroll
    for (int i = 0; i < (R + 31) / 32; ++i) {
      const int r = t0 + lane + 32 * i;
      if ((R >= 32 || lane < R) && r < T) {
        const int s = segb[r];
        seen |= s >= lo && s <= hi;
        other |= s != lo;
      }
    }
    if (__any_sync(0xffffffffu, seen)) {
      uniform = lo == hi && !__any_sync(0xffffffffu, other);
      return t0;
    }
  }
  uniform = false;
  return end;
}

}  // namespace mma
}  // namespace flash
