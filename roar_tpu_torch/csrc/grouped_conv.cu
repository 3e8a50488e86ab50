// K3 and K4: grouped 1-D convolution, channels-first, fp32: forward, input
// gradient and weight gradient.
//
// Replace roar_tpu/ops/grouped_conv.py `_core_kernel` (K3: the forward and,
// with a phase-packed transposed weight, dX) and `_dw_kernel` (K4: dW).  The
// TPU kernels fold the stride into channels and pack taps so that a 128-row
// matrix unit sees 128-lane tiles at static offsets; none of that is carried
// over.  Here stride, padding and group count are run-time arguments and the
// kernels index the raw tensors: x [B, Cin, W], w [Cout, Cin/G, k] (torch's
// layout), y [B, Cout, Wout], Wout = (W + 2 pad - k) / s + 1.
//
//   fwd  y[b, g Og + o, n]  = sum_{c, j} w[g Og + o, c, j] x[b, g Cg + c, n s + j - pad]
//   dX   dx[b, g Cg + c, m] = sum_{o, j : (m + pad - j) % s == 0}
//                               w[g Og + o, c, j] dy[b, g Og + o, (m + pad - j) / s]
//   dW   dw[g Og + o, c, j] = sum_{b, n} dy[b, g Og + o, n] x[b, g Cg + c, n s + j - pad]
//
// with x and dy read as zero outside their widths.
//
// What bounds them on an H100: operations.  The multi-scale discriminator's
// layers (41 taps, 8 to 64 channels per group) do 2 k Cg FLOP per output
// element, 650 to 5000 FLOP per 4-byte output, far above the card's 20 fp32
// FLOP per byte, so the bound is an arithmetic rate, not device memory.
//
// K3 (`conv_mma_kernel`, ONE device routine behind both entry points) runs
//   on the tensor cores: an implicit GEMM per (batch, group) with M = output
//   positions, N = the group's output channels, K = (input channel, tap)
//   pairs, and `mma.sync.m16n8k8` on TF32 with fp32 sums, in 3xTF32
//   (tf32x3.cuh: each operand split into big + small, three products per
//   k-chunk in a fresh accumulator flushed into a round-to-nearest sum).  One
//   TF32 product keeps 10 mantissa bits, about 3e-4 of the result's scale at
//   these contractions, over the fp32 bar of 2e-4.  Unflushed, the tensor
//   cores' truncating sums over 1312 to 2624 products drift to about 2.4e-5 of
//   the scale on an H100; flushed, 2.6e-6 at worst at the discriminator's
//   shapes (the flush costs about 5 % of the time).
//   Its bound is 3x the operations over the dense TF32 rate.
//   A block of 8 warps owns (batch, group, BM positions, BN <= 64 output
//   channels); the warps tile it WM x WN, each warp MT m-tiles of 16 by NT
//   n-tiles of 8.  The contraction runs over stages of `cc` input channels,
//   staged by 4-byte `cp.async` with zero fill (padding, ragged edges,
//   channels past the group) in two buffers, the next stage's copies in
//   flight while the current one is multiplied:
//   - the input window of a stage, split by stride phase so that the A
//     operand's row n, column (c, j) is word n + j / s of phase j % s: A is
//     the Toeplitz view x[c][n s + j - pad], never materialised, and a
//     fragment's rows are consecutive words;
//   - the weights of a stage, [n][(c, j)], a row stride = 4 (mod 32) so that
//     a B fragment's 32 words fall in 32 banks.
//   Both stay fp32 in shared memory and each fragment word is split after
//   its load (cvt, subtract, cvt): no second array, no splitting pass, and a
//   pre-split copy of the window (each word split once, by the thread that
//   copied it) measured no faster on an H100.  A warp covers up to 32 output
//   channels (4 n-tiles) before the block adds a second warp along N: its
//   MT x 4 A words and NT x 2 B words, each loaded and split once per
//   k-chunk, feed 3 MT NT products and 4 MT NT adds.
//   A per-block table maps a (channel, tap) column to its window offset and
//   its weight offset, so the inner loop does no division; stage columns are
//   padded to whole k-chunks of 8 with zero weights.  `cc` is the most
//   channels (8, 4, 2, 1) whose two stages fit two blocks on an SM.
//   dX is the same routine in another view: for each output phase r = m % s
//   only the taps j = (r + pad) % s + s t contribute, and they form a
//   stride-1 correlation of dy with the reversed sub-sampled weight, so a
//   block takes one (batch, phase) and contracts over the group's output
//   channels; weights are gathered transposed from the same tensor, nothing
//   is packed in device memory.  Tail positions that no tap reaches get 0.
//   No atomics: each output is one accumulator of one thread, summed in a
//   fixed order, so two runs give the same bits.
// K4 (`dw_mma_kernel` + `dw_reduce_kernel`) also runs on the tensor cores in
//   3xTF32: an implicit GEMM per group with M = the group's (input channel,
//   tap) pairs, N = its output channels (one n-tile of 8 per 8 of them, up
//   to 64 a block) and K = batch x width positions.  The TPU kernel carries
//   its sum along a sequential grid axis; blocks here run in no order, and
//   the output (G x Og x Cg k values) alone cannot fill 132 SMs, so the
//   positions are split into `parts` (a count that depends on the shape
//   only): a block of 4 warps owns (group, BM pairs, up to 64 output
//   channels, one part), each warp MT m-tiles of pairs by all the block's
//   n-tiles, and walks its part in items of 64 positions of one batch row.
//   Per item it stages, by `cp.async` with zero fill in two buffers (the
//   next item's copies in flight while this one is multiplied; 16-byte
//   copies where widths and padding keep them aligned, 4-byte ones
//   elsewhere; only the words the item's k-chunks read):
//   - the x window of the channels its pairs touch, contiguous per channel,
//     so that A row (c, j) at position n is word c cs + j + n s: the
//     Toeplitz view x[c][n s + j - pad], never materialised as columns; the
//     channel stride cs keeps a fragment's 8 rows x 4 positions in distinct
//     banks where the stride allows;
//   - the dy rows of all the block's output channels, row stride = 4 (mod
//     32), so that a B fragment's 32 words fall in 32 banks.
//   Each fragment word is split after its load (integer rounding, the bits
//   of `cvt.rna`); each k-chunk of 8 positions puts small.big, big.small
//   and big.big into a fresh accumulator that one round-to-nearest add puts
//   into the thread's sum, so the tensor cores' truncation touches 24
//   products at a time, not a part's walk of thousands of positions.
//   Splitting each staged word once into shared big and small halves
//   measured 13 % slower on an H100, interleaving those halves for 8-byte
//   loads slower still.
//   Tail positions past Wout are zeros, and a chunk that holds none is
//   skipped; m-tiles past the group's pairs are skipped by the whole warp.
//   The accumulators live for the whole walk; partial sums go to a
//   workspace and a second kernel adds them in part order: no float
//   atomics, so two runs give the same bits.
//
// `wgmma`, TMA and warp specialisation are later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attention_mma.cuh"  // cp.async helpers
#include "tf32x3.cuh"

namespace {

using flash::mma::cp_async16;
using flash::mma::cp_async4;
using flash::mma::cp_async_commit;
using flash::mma::cp_async_wait;
using tf32x3::mma_3xtf32;
using tf32x3::split_tf32;
using tf32x3::split_tf32_int;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDwWarps = 4;     // K4: warps per block, along the pairs
constexpr int kDwThreads = 32 * kDwWarps;
constexpr int kDwTile = 64;     // K4: contraction positions staged per item
constexpr int kDwRowStride = kDwTile + 4;  // K4: staged dy row stride, = 4 (mod 32)
constexpr int kDwTargetBlocks = 8 * 132;
constexpr size_t kMaxSmem = 227 * 1024;
// K3: two blocks a SM, each with 1 KB the system reserves, in the SM's 228 KB
constexpr size_t kTwoBlockSmem = 228 * 1024 / 2 - 1024;

struct ConvGeom {
  int B, G, Cg, Og, W, Wout, k, s, pad;
};

// K3's shared memory, in 4-byte words: two stages of [window | weights],
// then three column tables of `kpad` ints.  Sized for the most taps any
// block of the launch has (dX phases differ by one).
struct K3Smem {
  int pl;     // words per stride phase of a staged channel
  int cs;     // words per staged channel
  int kpad;   // (channel, tap) columns of a stage, in whole k-chunks of 8
  int ksp;    // row stride of the staged weights, = 4 (mod 32)
  int stage;  // words per stage
  __host__ __device__ size_t bytes() const { return 4ull * (2ull * stage + 3ull * kpad); }
};

__host__ __device__ inline K3Smem k3_smem(const ConvGeom& q, bool dx, int bm, int bn, int cc) {
  const int st = dx ? 1 : q.s;
  const int taps = dx ? (q.k + q.s - 1) / q.s : q.k;
  K3Smem L;
  // a fragment's 8 rows x 4 columns read phases j % st at rows + j / st: a
  // phase length of 32 / st (mod 32) puts the st phases in disjoint banks
  L.pl = bm + (taps - 1) / st;
  if (st > 1) L.pl += (((32 / st) - L.pl) % 32 + 32) % 32;
  L.cs = st * L.pl;
  L.kpad = (cc * taps + 7) / 8 * 8;
  L.ksp = L.kpad + ((4 - L.kpad) % 32 + 32) % 32;
  L.stage = cc * L.cs + bn * L.ksp;
  return L;
}

// K3.  DX = false: forward, `in` is x and `out` is y.  DX = true: input
// gradient, `in` is dy and `out` is dx, blockIdx.z = batch * s + phase.
// `cc` input channels per stage; `st_shift` = log2 of the view's stride, or
// -1 when it is not a power of two.
template <int WN, int NT, int MT, bool DX>
__global__ void __launch_bounds__(kThreads, 2)
conv_mma_kernel(const float* __restrict__ in, const float* __restrict__ w,
                float* __restrict__ out, ConvGeom q, int cc, int st_shift) {
  constexpr int WM = kWarps / WN;
  constexpr int BM = WM * MT * 16;  // output positions per block
  constexpr int BN = WN * NT * 8;   // output channels per block
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = warp % WM, wn = warp / WM;

  // this block's view: a stride-`st` correlation of `taps` taps with left
  // padding `pd` over an input of width `win`, giving `nout` positions
  const int b = DX ? blockIdx.z / q.s : blockIdx.z;
  const int r = DX ? blockIdx.z % q.s : 0;
  const int kc = DX ? q.Og : q.Cg;  // contraction channels per group
  const int oc = DX ? q.Cg : q.Og;  // output channels per group
  int taps = q.k, st = q.s, pd = q.pad, win = q.W, nout = q.Wout, j0 = 0;
  if (DX) {
    j0 = (r + q.pad) % q.s;
    const int d = (r + q.pad) / q.s;
    taps = j0 < q.k ? (q.k - j0 + q.s - 1) / q.s : 0;
    st = 1;
    pd = taps - 1 - d;
    win = q.Wout;
    nout = (q.W - r + q.s - 1) / q.s;
  }
  const int n0 = blockIdx.x * BM;
  if (n0 >= nout) return;
  const int o_tiles = (oc + BN - 1) / BN;
  const int grp = blockIdx.y / o_tiles;
  const int o0 = (blockIdx.y % o_tiles) * BN;

  const K3Smem L = k3_smem(q, DX, BM, BN, cc);
  int* xoff = reinterpret_cast<int*>(smem + 2 * L.stage);  // column -> window word
  int* wsrc = xoff + L.kpad;                                // column -> weight offset
  int* wch = wsrc + L.kpad;                                 // column -> stage channel
  const int ks = cc * taps;
  const int kpad = (ks + 7) / 8 * 8;
  for (int kk = tid; kk < kpad; kk += kThreads) {
    const int c = kk / taps, j = kk - c * taps;
    const bool real = kk < ks;
    xoff[kk] = real ? c * L.cs + (j % st) * L.pl + j / st : 0;
    wsrc[kk] = !real ? 0 : DX ? c * q.Cg * q.k + j0 + q.s * (taps - 1 - j) : kk;
    wch[kk] = real ? c : 1 << 30;
  }

  const int xw = (BM - 1) * st + taps;  // window length in input positions
  const int p0 = n0 * st - pd;          // input position of the window's start
  const float* in_g = in + (static_cast<size_t>(b) * q.G + grp) * kc * win;
  // weight offset of (row n, stage channel 0, column offset 0): forward
  // w[g Og + o0 + n][c0 + c][j]; dX w[g Og + c0 + c][o0 + n][j0 + s (taps-1-j)]
  auto w_row = [&](int c0, int n) -> size_t {
    return DX ? (static_cast<size_t>(grp) * q.Og + c0) * q.Cg * q.k +
                    static_cast<size_t>(o0 + n) * q.k
              : (static_cast<size_t>(grp) * q.Og + o0 + n) * q.Cg * q.k +
                    static_cast<size_t>(c0) * q.k;
  };

  // stage `s` into buffer `buf`: position p0 + i of channel c0 + c goes to
  // word c cs + (i % st) pl + i / st of the window
  auto copy_stage = [&](int s, int buf) {
    const int c0 = s * cc;
    float* xs = smem + buf * L.stage;
    float* ws = xs + cc * L.cs;
    for (int c = 0; c < cc; ++c) {
      const bool c_ok = c0 + c < kc;
      const float* src = in_g + static_cast<size_t>(c_ok ? c0 + c : 0) * win;
      for (int i = tid; i < xw; i += kThreads) {
        const int p = p0 + i;
        const bool ok = c_ok && p >= 0 && p < win;
        const int ix = st_shift >= 0 ? i >> st_shift : i / st;
        cp_async4(xs + c * L.cs + (i - ix * st) * L.pl + ix, ok ? src + p : in, ok);
      }
    }
    for (int kk = lane; kk < kpad; kk += 32) {
      const int off = wsrc[kk];
      const bool k_ok = c0 + wch[kk] < kc;
      for (int n = warp; n < BN; n += kWarps) {
        const bool ok = k_ok && o0 + n < oc;
        cp_async4(ws + n * L.ksp + kk, ok ? w + w_row(c0, n) + off : w, ok);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  auto compute = [&](int buf) {
    const float* xs = smem + buf * L.stage;
    const float* wrow = xs + cc * L.cs + (wn * NT * 8 + g8) * L.ksp + t4;
    const int row0 = wm * MT * 16 + g8;
#pragma unroll 1  // unrolled twice, a warp's 2 x 4 fragment tiles spill
    for (int k0 = 0; k0 < kpad; k0 += 8) {
      const int ca = xoff[k0 + t4] + row0, cb = xoff[k0 + t4 + 4] + row0;
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 16 * mt;
        split_tf32(xs[ca + m], ab[mt][0], as[mt][0]);
        split_tf32(xs[ca + m + 8], ab[mt][1], as[mt][1]);
        split_tf32(xs[cb + m], ab[mt][2], as[mt][2]);
        split_tf32(xs[cb + m + 8], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(wrow[nt * 8 * L.ksp + k0], bb0, bs0);
        split_tf32(wrow[nt * 8 * L.ksp + k0 + 4], bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(acc[mt][nt], ab[mt], as[mt], bb0, bb1, bs0, bs1);
      }
    }
  };

  // two buffers: stage s + 1's copies fly while stage s is multiplied
  const int n_stages = taps > 0 ? (kc + cc - 1) / cc : 0;
  __syncthreads();  // the tables
  if (n_stages > 0) copy_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) copy_stage(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of stage s have landed
    __syncthreads();     // and everyone's
    compute(s & 1);
    __syncthreads();     // buffer s & 1 is free for stage s + 2
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = n0 + wm * MT * 16 + 16 * mt + g8 + 8 * (e >> 1);
        const int o = o0 + wn * NT * 8 + 8 * nt + 2 * t4 + (e & 1);
        if (pos >= nout || o >= oc) continue;
        if (DX) {
          out[((static_cast<size_t>(b) * q.G + grp) * q.Cg + o) * q.W + pos * q.s + r] =
              acc[mt][nt][e];
        } else {
          out[((static_cast<size_t>(b) * q.G + grp) * q.Og + o) * q.Wout + pos] =
              acc[mt][nt][e];
        }
      }
    }
  }
}

// K4's layout for one launch (words): one stage is the x windows of `nch`
// channels, `cs` words each, then BN dy rows of kDwRowStride words; shared
// memory holds two stages.
struct DwLayout {
  int nch;       // channels the block's pairs can touch
  int cs;        // words per staged channel window, a multiple of 4
  int xw;        // nch * cs
  int stage;     // xw + BN * kDwRowStride
  int per_part;  // items (batch row, 64 positions) per part
  int vec_x;     // 1: the windows go by 16-byte copies
  int vec_dy;    // 1: the dy rows go by 16-byte copies
};

// K4, first pass.  Block (x: tile of BM (channel, tap) pairs of the group,
// y: group and output-channel tile, z: part).  Writes
// out[part][g Og + o][c k + j] for its tile.  The block's warps split the
// pairs, each MT m-tiles of 16 by NT n-tiles of 8 (all the block's outputs).
template <int NT, int MT>
__global__ void __launch_bounds__(kDwThreads)
dw_mma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              float* __restrict__ out, ConvGeom q, DwLayout L) {
  constexpr int BM = kDwWarps * MT * 16;
  constexpr int BN = NT * 8;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;

  const int pairs = q.Cg * q.k;
  const int e0 = blockIdx.x * BM;
  const int o_tiles = (q.Og + BN - 1) / BN;
  const int grp = blockIdx.y / o_tiles;
  const int o0 = (blockIdx.y % o_tiles) * BN;
  const int part = blockIdx.z;
  const int c_lo = e0 / q.k;
  const int m_warp = warp * MT * 16;
  // m-tiles of this warp that hold a pair of the group (warp-uniform)
  const int live = min(MT, max(0, (pairs - e0 - m_warp + 15) / 16));

  // window word of A row m (a pair) at position 0; rows past the group's
  // pairs read word 0 and are never stored
  int roff[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + m_warp + 16 * mt + g8 + 8 * h;
      const int c = e / q.k;
      roff[mt][h] = e < pairs ? (c - c_lo) * L.cs + (e - c * q.k) : 0;
    }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const int n_tiles = (q.Wout + kDwTile - 1) / kDwTile;
  const int total = q.B * n_tiles;
  const int first = part * L.per_part;
  const int last = min(first + L.per_part, total);

  // item (batch row b, positions n0 ..): its positions rounded up to whole
  // k-chunks, and the window words those read, rounded up to 4
  auto positions = [&](int item) {
    const int n0 = (item % n_tiles) * kDwTile;
    return (min(kDwTile, q.Wout - n0) + 7) / 8 * 8;
  };
  auto window = [&](int nv8) { return ((nv8 - 1) * q.s + q.k + 3) / 4 * 4; };

  // stage an item into buffer `raw`: window word i of channel c_lo + c is x
  // position n0 s - pad + i; only the words its k-chunks read
  auto copy_item = [&](int item, float* raw) {
    const int b = item / n_tiles;
    const int n0 = (item - b * n_tiles) * kDwTile;
    const int nv8 = positions(item), len4 = window(nv8);
    const int p0 = n0 * q.s - q.pad;
    const float* xg = x + (static_cast<size_t>(b) * q.G + grp) * q.Cg * q.W;
    // a warp per channel window, a thread per copy: no division
    for (int c = warp; c < L.nch; c += kDwWarps) {
      const bool c_ok = c_lo + c < q.Cg;
      const float* src = xg + static_cast<size_t>(c_ok ? c_lo + c : 0) * q.W;
      if (L.vec_x) {  // W, p0 multiples of 4: a chunk is all inside or all outside
        for (int w = 4 * lane; w < len4; w += 128) {
          const int p = p0 + w;
          const bool ok = c_ok && p >= 0 && p < q.W;
          cp_async16(raw + c * L.cs + w, ok ? src + p : x, ok);
        }
      } else {
        for (int i = lane; i < len4; i += 32) {
          const int p = p0 + i;
          const bool ok = c_ok && p >= 0 && p < q.W;
          cp_async4(raw + c * L.cs + i, ok ? src + p : x, ok);
        }
      }
    }
    const float* dg = dy + ((static_cast<size_t>(b) * q.G + grp) * q.Og + o0) * q.Wout + n0;
    float* ds = raw + L.xw;
    if (L.vec_dy) {  // Wout, n0 multiples of 4
      constexpr int chunks = kDwTile / 4;
      for (int i = tid; i < BN * chunks; i += kDwThreads) {
        const int o = i / chunks, n = (i % chunks) * 4;
        if (n >= nv8) continue;
        const bool ok = o0 + o < q.Og && n0 + n < q.Wout;
        cp_async16(ds + o * kDwRowStride + n, ok ? dg + static_cast<size_t>(o) * q.Wout + n : dy,
                   ok);
      }
    } else {
      for (int i = tid; i < BN * kDwTile; i += kDwThreads) {
        const int o = i / kDwTile, n = i % kDwTile;
        if (n >= nv8) continue;
        const bool ok = o0 + o < q.Og && n0 + n < q.Wout;
        cp_async4(ds + o * kDwRowStride + n, ok ? dg + static_cast<size_t>(o) * q.Wout + n : dy,
                  ok);
      }
    }
  };

  auto compute = [&](int n_valid, const float* buf) {
    const float* dsrc = buf + L.xw + g8 * kDwRowStride + t4;
#pragma unroll 1
    for (int k0 = 0; k0 < n_valid; k0 += 8) {
      const int pa = (k0 + t4) * q.s, pb = pa + 4 * q.s;
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32_int(buf[roff[mt][0] + pa], ab[mt][0], as[mt][0]);
        split_tf32_int(buf[roff[mt][1] + pa], ab[mt][1], as[mt][1]);
        split_tf32_int(buf[roff[mt][0] + pb], ab[mt][2], as[mt][2]);
        split_tf32_int(buf[roff[mt][1] + pb], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 * kDwRowStride + k0;
        uint32_t bb0, bb1, bs0, bs1;
        split_tf32_int(dsrc[d], bb0, bs0);
        split_tf32_int(dsrc[d + 4], bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (mt < live) mma_3xtf32(acc[mt][nt], ab[mt], as[mt], bb0, bb1, bs0, bs1);
      }
    }
  };

  // the next item's copies fly while this one is multiplied
  copy_item(first, smem);
  cp_async_commit();
  for (int item = first; item < last; ++item) {
    const int buf = (item - first) & 1;
    if (item + 1 < last) copy_item(item + 1, smem + (buf ^ 1) * L.stage);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of the item have landed
    __syncthreads();     // and everyone's
    if (live > 0) compute(positions(item), smem + buf * L.stage);
    __syncthreads();     // buffer `buf` is free for the item after next
  }

  float* dst = out + static_cast<size_t>(part) * q.G * q.Og * pairs;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pair = e0 + m_warp + 16 * mt + g8 + 8 * (e >> 1);
        const int o = o0 + nt * 8 + 2 * t4 + (e & 1);
        if (pair < pairs && o < q.Og)
          dst[(static_cast<size_t>(grp) * q.Og + o) * pairs + pair] = acc[mt][nt][e];
      }
    }
  }
}

// K4, second pass: the parts added in part order.
__global__ void dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                 int parts, size_t numel) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= numel) return;
  float sum = 0.0f;
  for (int p = 0; p < parts; ++p) sum += partial[p * numel + i];
  dw[i] = sum;
}

bool geom_ok(const ConvGeom& q) {
  return q.B >= 1 && q.G >= 1 && q.Cg >= 1 && q.Og >= 1 && q.W >= 1 && q.Wout >= 1 &&
         q.k >= 1 && q.s >= 1 && q.pad >= 0 && q.pad < q.k &&
         q.Wout == (q.W + 2 * q.pad - q.k) / q.s + 1 && q.W + 2 * q.pad >= q.k;
}

// K3: input channels per stage, the most of 8, 4, 2, 1 (no more than the
// group has) whose two stages fit two blocks a SM; 0 if not even one fits a block
int k3_channels_per_stage(const ConvGeom& q, bool dx, int bm, int bn) {
  const int kc = dx ? q.Og : q.Cg;
  int cc = 8;
  while (cc > 1 && cc / 2 >= kc) cc /= 2;
  while (cc > 1 && k3_smem(q, dx, bm, bn, cc).bytes() > kTwoBlockSmem) cc /= 2;
  return k3_smem(q, dx, bm, bn, cc).bytes() <= kMaxSmem ? cc : 0;
}

template <int WN, int NT, int MT, bool DX>
int launch_conv_mma(const float* in, const float* w, float* out, const ConvGeom& q,
                    cudaStream_t stream) {
  constexpr int BM = (kWarps / WN) * MT * 16, BN = WN * NT * 8;
  const int oc = DX ? q.Cg : q.Og;
  const int nout = DX ? (q.W + q.s - 1) / q.s : q.Wout;  // the most any phase has
  const int cc = k3_channels_per_stage(q, DX, BM, BN);
  if (cc == 0) return cudaErrorInvalidValue;
  const size_t smem = k3_smem(q, DX, BM, BN, cc).bytes();
  const long long grid_y = static_cast<long long>(q.G) * ((oc + BN - 1) / BN);
  const long long grid_z = static_cast<long long>(q.B) * (DX ? q.s : 1);
  if (grid_y > 65535 || grid_z > 65535) return cudaErrorInvalidValue;
  auto kernel = conv_mma_kernel<WN, NT, MT, DX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int st = DX ? 1 : q.s;
  int st_shift = -1;
  for (int sh = 0; sh < 16; ++sh)
    if ((1 << sh) == st) st_shift = sh;
  const dim3 grid((nout + BM - 1) / BM, static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(grid_z));
  kernel<<<grid, kThreads, smem, stream>>>(in, w, out, q, cc, st_shift);
  return cudaGetLastError();
}

int padded(int n, int tile) { return (n + tile - 1) / tile * tile; }

// Output channels per block: the least of 8, 16, 32, 64 that holds the
// group's (wider groups take several blocks), one warp across up to 32 of
// them; positions per block: the warps' rows x 16 or twice that, the less
// padded, the larger on a tie.
template <bool DX>
int dispatch_conv_mma(const float* in, const float* w, float* out, const ConvGeom& q,
                      cudaStream_t stream) {
  const int oc = DX ? q.Cg : q.Og;
  const int nout = DX ? (q.W + q.s - 1) / q.s : q.Wout;
#define ROAR_CASE(WN_, NT_)                                                        \
  {                                                                                \
    constexpr int bm = (kWarps / WN_) * 16;                                        \
    return padded(nout, bm) < padded(nout, 2 * bm)                                 \
               ? launch_conv_mma<WN_, NT_, 1, DX>(in, w, out, q, stream)           \
               : launch_conv_mma<WN_, NT_, 2, DX>(in, w, out, q, stream);          \
  }
  if (oc <= 8) ROAR_CASE(1, 1)
  if (oc <= 16) ROAR_CASE(1, 2)
  if (oc <= 32) ROAR_CASE(1, 4)
  ROAR_CASE(2, 4)
#undef ROAR_CASE
}

// K4's tiles: n-tiles of 8 output channels per block (all of a group's, up
// to 64) and m-tiles of 16 pairs per warp, 16 to 64 accumulators a thread
struct DwTiles {
  int nt, mt;
};

DwTiles dw_tiles(const ConvGeom& q) {
  if (q.Og <= 8) return {1, 4};
  if (q.Og <= 16) return {2, 4};
  if (q.Og <= 32) return {4, 4};
  return {8, 2};
}

// Blocks of the first pass without a split, and position items to split.
void dw_shape(const ConvGeom& q, int* base_blocks, int* total_items) {
  const DwTiles t = dw_tiles(q);
  const int bm = kDwWarps * t.mt * 16, bn = t.nt * 8;
  *base_blocks = (q.Cg * q.k + bm - 1) / bm * q.G * ((q.Og + bn - 1) / bn);
  *total_items = q.B * ((q.Wout + kDwTile - 1) / kDwTile);
}

int dw_parts(const ConvGeom& q) {
  int base, total;
  dw_shape(q, &base, &total);
  int parts = (kDwTargetBlocks + base - 1) / base;
  parts = parts < 1 ? 1 : (parts > total ? total : parts);
  const int per = (total + parts - 1) / parts;
  return (total + per - 1) / per;  // no empty part
}

// The channel stride of the staged windows: a multiple of 4 words (16-byte
// copies) at least `len4`, and where one exists, one that puts a fragment's
// rows on both sides of a channel boundary in distinct banks: channel c + 1
// continues channel c's banks after a gap d = (cs - k) mod 32 with
// 3 s <= d <= 24 - 3 s.
int dw_channel_stride(int len4, int k, int s) {
  for (int cs = len4; cs < len4 + 32; cs += 4) {
    const int d = ((cs - k) % 32 + 32) % 32;
    if (d >= 3 * s && d <= 24 - 3 * s) return cs;
  }
  return len4;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int NT, int MT>
int launch_dw(const float* x, const float* dy, float* dw, float* workspace, const ConvGeom& q,
              int parts, cudaStream_t stream) {
  constexpr int BM = kDwWarps * MT * 16, BN = NT * 8;
  int base, total;
  dw_shape(q, &base, &total);
  DwLayout L;
  L.nch = min(q.Cg, (BM + q.k - 2) / q.k + 1);
  L.cs = dw_channel_stride(((kDwTile - 1) * q.s + q.k + 3) / 4 * 4, q.k, q.s);
  L.xw = L.nch * L.cs;
  L.stage = L.xw + BN * kDwRowStride;
  L.per_part = (total + parts - 1) / parts;
  L.vec_x = q.W % 4 == 0 && q.pad % 4 == 0 && aligned16(x);
  L.vec_dy = q.Wout % 4 == 0 && aligned16(dy);
  const size_t smem = 2ull * 4 * L.stage;
  const long long grid_y = static_cast<long long>(q.G) * ((q.Og + BN - 1) / BN);
  if (smem > kMaxSmem || grid_y > 65535 || parts > 65535) return cudaErrorInvalidValue;
  auto kernel = dw_mma_kernel<NT, MT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((q.Cg * q.k + BM - 1) / BM, static_cast<unsigned>(grid_y), parts);
  kernel<<<grid, kDwThreads, smem, stream>>>(x, dy, parts > 1 ? workspace : dw, q, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return err;
  const size_t numel = static_cast<size_t>(q.G) * q.Og * q.Cg * q.k;
  dw_reduce_kernel<<<static_cast<unsigned>((numel + 255) / 256), 256, 0, stream>>>(
      workspace, dw, parts, numel);
  return cudaGetLastError();
}

ConvGeom make_geom(int B, int Cin, int W, int Cout, int k, int s, int pad, int G, int Wout) {
  ConvGeom q;
  q.B = B; q.G = G; q.Cg = G > 0 ? Cin / G : 0; q.Og = G > 0 ? Cout / G : 0;
  q.W = W; q.Wout = Wout; q.k = k; q.s = s; q.pad = pad;
  return q;
}

}  // namespace

// Every entry returns the CUDA error of its launch (0 on success) and 1
// (cudaErrorInvalidValue) for sizes the kernels do not take.  All tensors are
// contiguous fp32: x [B, Cin, W], w [Cout, Cin/G, k], y and dy [B, Cout, Wout].

extern "C" int roar_grouped_conv_fwd(
    const void* x, const void* w, void* y, int B, int Cin, int W, int Cout, int k, int s,
    int pad, int G, int Wout, void* stream) {
  if (G < 1 || Cin % G || Cout % G) return cudaErrorInvalidValue;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q)) return cudaErrorInvalidValue;
  return dispatch_conv_mma<false>(static_cast<const float*>(x), static_cast<const float*>(w),
                                   static_cast<float*>(y), q, static_cast<cudaStream_t>(stream));
}

extern "C" int roar_grouped_conv_dx(
    const void* dy, const void* w, void* dx, int B, int Cin, int W, int Cout, int k, int s,
    int pad, int G, int Wout, void* stream) {
  if (G < 1 || Cin % G || Cout % G) return cudaErrorInvalidValue;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q)) return cudaErrorInvalidValue;
  return dispatch_conv_mma<true>(static_cast<const float*>(dy), static_cast<const float*>(w),
                                  static_cast<float*>(dx), q, static_cast<cudaStream_t>(stream));
}

// Number of parts the weight gradient splits batch x width into; the caller
// allocates a workspace of parts * Cout * Cin/G * k floats when it is > 1.
extern "C" int roar_grouped_conv_dw_parts(
    int B, int Cin, int W, int Cout, int k, int s, int pad, int G, int Wout) {
  if (G < 1 || Cin % G || Cout % G) return 0;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  return geom_ok(q) ? dw_parts(q) : 0;
}

extern "C" int roar_grouped_conv_dw(
    const void* x, const void* dy, void* dw, void* workspace, int B, int Cin, int W, int Cout,
    int k, int s, int pad, int G, int Wout, int parts, void* stream) {
  if (G < 1 || Cin % G || Cout % G) return cudaErrorInvalidValue;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q) || parts != dw_parts(q) || (parts > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* dyp = static_cast<const float*>(dy);
  float* dwp = static_cast<float*>(dw);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dw_tiles(q).nt) {
    case 1: return launch_dw<1, 4>(xp, dyp, dwp, ws, q, parts, st);
    case 2: return launch_dw<2, 4>(xp, dyp, dwp, ws, q, parts, st);
    case 4: return launch_dw<4, 4>(xp, dyp, dwp, ws, q, parts, st);
    default: return launch_dw<8, 2>(xp, dyp, dwp, ws, q, parts, st);
  }
}
