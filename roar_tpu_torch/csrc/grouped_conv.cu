// K3 and K4: grouped 1-D convolution, channels-first, fp32 or bf16: forward,
// input gradient and weight gradient.
//
// Replace roar_tpu/ops/grouped_conv.py `_core_kernel` (K3: the forward and,
// with a phase-packed transposed weight, dX) and `_dw_kernel` (K4: dW).  The
// TPU kernels fold the stride into channels and pack taps so that a 128-row
// matrix unit sees 128-lane tiles at static offsets.  The fp32 kernels carry
// none of that over: stride, padding and group count are run-time arguments
// and they index the raw tensors: x [B, Cin, W], w [Cout, Cin/G, k] (torch's
// layout), y [B, Cout, Wout], Wout = (W + 2 pad - k) / s + 1.  The bf16 K3
// and K4 fold the stride into channels as the TPU does, channels-last
// (below).
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
// K3 in fp32 (`conv_mma_kernel`, ONE device routine behind both entry points) runs
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
// K4 in fp32 (`dw_mma_kernel` + `dw_reduce_kernel`) also runs on the tensor
//   cores in 3xTF32: an implicit GEMM per group with M = the group's (input
//   channel, tap) pairs, N = its output channels (one n-tile of 8 per 8 of
//   them, up to 64 a block) and K = batch x width positions.  The TPU kernel carries
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
// bf16 (the JAX package's bf16 step: bf16 operands, fp32 sums, y and dX
//   written in bf16, dW in fp32).
// K3 in bf16 (`conv_bf16_kernel`, forward and dX one device routine) is
//   bound by operations too: at the discriminator's 15 shapes 2 k Cg FLOP an
//   output element is 656 to 5248 FLOP per 2-byte output, far above
//   the card's 295 bf16 FLOP per byte, so its bound is the dense bf16 rate.
//   What kept a direct kernel far from it: odd widths (8193, 4097) put a
//   channel row of x on a 2-byte boundary, so no 16-byte or TMA copy of the
//   raw rows exists; a strided Toeplitz view needs per-element gathers; and
//   bf16 widened to fp32 in shared memory halves the channels a stage holds.
//   So a call is three launches:
//   - `pack_w_bf16_kernel` packs the weights K-major in the folded channel
//     order (the TPU's `_pack_w_fwd` / `_pack_w_dx`, for dX each output
//     phase's reversed sub-sampled weight), zero past the taps;
//   - `fold_bf16_kernel`, the layout pass, writes the input channels-last
//     with the stride folded into channels (the TPU's `_fold_x`): x'[g][b][m]
//     [c s + ph] = x[b][g Cg + c][m s + ph - pad], rows of Kc = Cg s rounded
//     up to 16 channels, the halo zero; for dX dy the same with s 1 (each
//     output phase of dX is a stride-1 correlation of dy).  A stride-s conv
//     over k taps becomes a stride-1 conv over ceil(k / s) taps whose A tile
//     for tap t is the row-shifted contiguous tile x'[p + t], and the rows of
//     consecutive batch rows are consecutive, so one GEMM runs over B L flat
//     rows and a short layer's tile takes the next batch row's positions
//     (the halo rows between them are computed and dropped);
//   - `conv_bf16_kernel` multiplies: stages of (taps, channels) by 16-byte
//     `cp.async` into a ring of three, bf16 kept bf16 in shared memory, the
//     next two stages' copies in flight under this one's products, each
//     block walking several position tiles as one stream of stages;
//     `ldmatrix` and `mma.sync.m16n8k16` bf16 at the bf16 rate with fp32
//     sums (products of bf16 values are exact, so no flush is needed), y or
//     dX rounded once to bf16 through shared memory.
//   The pack and the layout pass move bytes (x read once and its folded copy
//   written once: about 1.1 GB over the 15 shapes at 32 x 16384) and count in
//   K3's time.  No atomics: each output is one accumulator summed in a fixed
//   order, so two runs give the same bits.
//
// K4 in bf16 (`dw_bf16_kernel` + `dw_unpack_bf16_kernel`) is bound by
//   operations as K3 is, and met the same obstacles (odd widths, a strided
//   Toeplitz view gathered word by word, bf16 widened in shared memory), so it
//   contracts the same folded layout, as the TPU's `_dw` contracts the
//   forward's folded x.  A call is four launches:
//   - `fold_bf16_kernel` folds x with the forward's view into x' (L = Wout +
//     T - 1 rows a batch row), and again dy with C = Og, s 1, to the same
//     rows: dy'[g][b L + n][o] = dy[b][g Og + o][n], zero at n >= Wout;
//   - `dw_bf16_kernel`: one implicit GEMM per group, dWf[g][o][t][cf] = sum
//     over flat rows p of dy'[p][o] x'[p + t][cf], with M = (tap, folded
//     channel) pairs, N = output channels, K = the B L flat rows, split into
//     `parts` (a count that depends on the shape only) so that the small
//     output fills the card.  A stage of 128 flat rows holds the x' window
//     that contains the row-shifted A tiles of all the block's taps and the
//     dy' rows, by 16-byte `cp.async` into a ring of three, bf16 kept bf16;
//     K runs along the rows, so A and B are `ldmatrix.trans` loads, and
//     products run on `mma.sync.m16n8k16` bf16 with fp32 sums (exact
//     products, no flush); a block writes its part's sums to a workspace;
//   - `dw_unpack_bf16_kernel` adds the parts in part order and writes
//     dw[g Og + o][c][t s + ph] from dWf[g][o][t][c s + ph], dropping the
//     padded channels and taps, a dw row at a time through shared memory
//     (reads and writes in order).
//   The zero rows of dy' make the halo rows between batch rows add nothing.
//   No atomics: two runs give the same bits.
//
// A `wgmma` form of the bf16 main kernel (A by `ldmatrix` from the window,
// since a row-shifted tile is no descriptor's; B 128-byte swizzled through a
// descriptor; N 32 or 64) measured slower on an H100 than `mma.sync` at the
// discriminator's widths.  TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "flash_attention_mma.cuh"  // cp.async helpers
#include "tf32x3.cuh"

namespace {

using flash::mma::cp_async16;
using flash::mma::cp_async4;
using flash::mma::cp_async_commit;
using flash::mma::cp_async_wait;
using flash::mma::ldmatrix_x4;
using flash::mma::ldmatrix_x4_trans;
using flash::mma::mma_bf16;
using tf32x3::mma_3xtf32;
using tf32x3::split_tf32;
using tf32x3::split_tf32_int;
using bf16 = __nv_bfloat16;

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

  // stage `s` into buffer `buf` by `cp.async`: position p0 + i of channel
  // c0 + c goes to word c cs + (i % st) pl + i / st of the window
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
          out[((static_cast<size_t>(b) * q.G + grp) * q.Og + o) * q.Wout + pos] = acc[mt][nt][e];
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
int dispatch_conv_mma(const void* in_, const void* w_, void* out_, const ConvGeom& q,
                      cudaStream_t stream) {
  const auto* in = static_cast<const float*>(in_);
  const auto* w = static_cast<const float*>(w_);
  auto* out = static_cast<float*>(out_);
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

// ---------------------------------------------------------------------------
// K3 in bf16: a weight pack, a layout pass and one tensor-core kernel.

// One bf16 K3 call as a stride-1 correlation over a folded, channels-last
// input.  The input tensor (x for the forward, dy for dX) has C channels per
// group and width `win`; its fold is in'[g][b][m][c st + ph] = in[b][g C + c]
// [m st + ph - off] (zero outside the width and past C st), rows of Kc
// channels (C st rounded up to 16: whole 16-byte pieces, whole k-steps of
// 16), L rows per (group, batch row).  Output q of phase r in batch row b is
// flat row p = b L + q of its group and reads flat rows p + base + u,
// u < taps.
struct Bf16View {
  int B, G;
  int dx;      // 0 forward, 1 input gradient
  int C, win;  // input channels per group and width
  int st;      // phases folded into a row: s (forward), 1 (dX)
  int off;     // row 0 starts at input position -off
  int pl;      // dX: rows of zeros before dy's first position
  int L;       // folded rows per (group, batch row)
  int Kc;      // folded channels per row, a multiple of 16
  int T;       // taps per packed weight row (the most any phase has)
  int OC;      // output channels per group
  int phases;  // 1 (forward), s (dX)
  int ck, tg;  // main kernel: channels and taps per stage
  int tpb;     // main kernel: position tiles a block walks
};

// Phase r of a view: `taps` taps, `nout` outputs, output q reads folded rows
// q + base .. q + base + taps - 1 of its batch row.  dX phase r (outputs
// m = q s + r) takes the taps j = j0 + s u of the weight, reversed: a
// stride-1 correlation of dy (see the note at the top).
struct Bf16Phase {
  int taps, base, nout, j0;
};

__host__ __device__ inline Bf16Phase bf16_phase(const ConvGeom& q, const Bf16View& v, int r) {
  if (!v.dx) return {v.T, 0, q.Wout, 0};
  const int j0 = (r + q.pad) % q.s, d = (r + q.pad) / q.s;
  const int taps = j0 < q.k ? (q.k - j0 + q.s - 1) / q.s : 0;
  return {taps, v.pl - (taps - 1 - d), (q.W - r + q.s - 1) / q.s, j0};
}

Bf16View bf16_view(const ConvGeom& q, bool dx) {
  Bf16View v{};
  v.B = q.B; v.G = q.G; v.dx = dx;
  v.T = (q.k + q.s - 1) / q.s;
  if (!dx) {
    v.C = q.Cg; v.win = q.W; v.st = q.s; v.off = q.pad; v.pl = 0;
    v.L = q.Wout + v.T - 1; v.OC = q.Og; v.phases = 1;
  } else {
    v.C = q.Og; v.win = q.Wout; v.st = 1; v.OC = q.Cg; v.phases = q.s;
    // zeros before dy: enough for the phase that reaches furthest left
    for (int r = 0; r < q.s; ++r) {
      const int d = (r + q.pad) / q.s, taps = bf16_phase(q, v, r).taps;
      if (taps > 0) v.pl = max(v.pl, taps - 1 - d);
    }
    v.off = v.pl;
    v.L = 1;
    for (int r = 0; r < q.s; ++r) {
      const Bf16Phase p = bf16_phase(q, v, r);
      if (p.taps > 0) v.L = max(v.L, p.base + p.nout + p.taps - 1);
    }
  }
  v.Kc = (v.C * v.st + 15) / 16 * 16;
  return v;
}

// the folded input's elements, rounded up so that the packed weights after
// it start 256-byte aligned
size_t bf16_fold_elems(const Bf16View& v) {
  return (static_cast<size_t>(v.G) * v.B * v.L * v.Kc + 127) / 128 * 128;
}

size_t bf16_workspace_bytes(const Bf16View& v) {
  return 2 * (bf16_fold_elems(v) + static_cast<size_t>(v.phases) * v.G * v.OC * v.T * v.Kc);
}

// The weights in the order of the folded channels, K-major: forward
// wp[g][o][t][c s + ph] = w[g Og + o][c][t s + ph]; dX phase r
// wp[r][g][c][u][o] = w[g Og + o][c][j0 + s (taps - 1 - u)] (the reversed
// sub-sampled weight); zero past the taps and channels.  A block writes one
// packed row (T Kc values) from the sources staged in shared memory, read
// in their own order: the forward's row (g, o) is w's row g Og + o (Cg k
// values), dX's row (r, g, c) takes the k taps of channel c from each of the
// group's Og rows.
constexpr int kPackThreads = 128;

__global__ void __launch_bounds__(kPackThreads)
pack_w_bf16_kernel(const bf16* __restrict__ w, bf16* __restrict__ wp, ConvGeom q, Bf16View v) {
  extern __shared__ __align__(16) unsigned char pack_raw[];
  bf16* src = reinterpret_cast<bf16*>(pack_raw);
  const int n = blockIdx.x, g = blockIdx.y, r = blockIdx.z;
  const int len = v.T * v.Kc;
  bf16* dst = wp + ((static_cast<size_t>(r) * v.G + g) * v.OC + n) * len;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  if (!v.dx) {
    const bf16* row = w + (static_cast<size_t>(g) * q.Og + n) * q.Cg * q.k;
    for (int i = threadIdx.x; i < q.Cg * q.k; i += kPackThreads) src[i] = row[i];
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kPackThreads) {
      const int t = i / v.Kc, cf = i - t * v.Kc;
      const int c = cf / q.s, j = t * q.s + (cf - c * q.s);
      dst[i] = c < q.Cg && j < q.k ? src[c * q.k + j] : zero;
    }
  } else {
    for (int i = threadIdx.x; i < q.Og * q.k; i += kPackThreads) {
      const int o = i / q.k;
      src[i] = w[((static_cast<size_t>(g) * q.Og + o) * q.Cg + n) * q.k + (i - o * q.k)];
    }
    __syncthreads();
    const Bf16Phase p = bf16_phase(q, v, r);
    for (int i = threadIdx.x; i < len; i += kPackThreads) {
      const int u = i / v.Kc, o = i - u * v.Kc;
      dst[i] = o < q.Og && u < p.taps ? src[o * q.k + p.j0 + q.s * (p.taps - 1 - u)] : zero;
    }
  }
}

constexpr int kStages = 3;                 // the main kernel's ring of stages
constexpr int kBf16Sms = 132;              // the H100's SMs
constexpr int kBf16Waves = 4;              // main kernel: blocks for about 4 waves
constexpr int kFoldCols = 64;              // folded channels a block of the layout pass writes
constexpr int kFoldTile = 64 * (kFoldCols + 2);  // its staged tile, bf16
constexpr int kFoldThreads = 256;

// Folded rows a block of the layout pass writes: 64 rows of 64 channels, or
// as many more rows as fewer channels leave room for (a multiple of 8)
__host__ __device__ inline int fold_rows(int kc) {
  const int cols = kc < kFoldCols ? kc : kFoldCols;
  return kFoldTile / (cols + 2) / 8 * 8;
}

// The layout pass: block (rows m0.., channels cc0.., group x batch row) reads
// each input channel's stretch of rows x st positions, in aligned 16-byte
// pieces where the source is 16-byte aligned (the pieces straddle the
// stretch's ends; only its positions are kept), transposes it in shared
// memory (a row of an odd count of words: the writes of consecutive
// positions fall in distinct banks) and writes whole 16-byte pieces of
// folded rows.  ST is the view's st where it is 1, 2 or 4, else 0 (read at
// run time).
template <int ST>
__global__ void __launch_bounds__(kFoldThreads)
fold_bf16_kernel(const bf16* __restrict__ src, bf16* __restrict__ dst, Bf16View v,
                 long long numel, int vec) {
  __shared__ __align__(16) bf16 tile[kFoldTile];
  const int st = ST > 0 ? ST : v.st;
  const int rows = fold_rows(v.Kc);
  const int cols = min(kFoldCols, v.Kc - static_cast<int>(blockIdx.y) * kFoldCols);
  const int pitch = cols + 2;
  const int m0 = blockIdx.x * rows, cc0 = blockIdx.y * kFoldCols;
  const int g = blockIdx.z / v.B, b = blockIdx.z - g * v.B;
  const int creal = v.C * st;
  const int c_lo = cc0 / st, c_hi = min(v.C, (cc0 + cols + st - 1) / st);
  const int span = rows * st;
  const int p0 = m0 * st - v.off;
  const long long base = (static_cast<long long>(b) * v.G + g) * v.C * v.win;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  // zeros where the stretch leaves the width or the channels run out
  if (p0 < 0 || p0 + span > v.win || cc0 + cols > creal)
    for (int i = threadIdx.x; i < rows * pitch; i += kFoldThreads) tile[i] = zero;
  __syncthreads();
  const int lo = max(p0, 0), hi = min(p0 + span, v.win);
  // position pos of stretch channel c_lo + cr goes to tile row (pos - p0) / st
  auto put = [&](int cr, int pos, bf16 val) {
    const int e = pos - p0, m = e / st;
    const int col = (c_lo + cr) * st + (e - m * st) - cc0;
    if (col >= 0 && col < cols) tile[m * pitch + col] = val;
  };
  if (lo < hi) {
    if (vec) {
      // pieces of 8 covering elements base + c win + lo .. base + c win + hi - 1
      const int per = (hi - lo + 14) / 8 + 1;
      const int n = (c_hi - c_lo) * per;
      for (int i = threadIdx.x; i < n; i += kFoldThreads) {
        const int cr = i / per;
        const long long row = base + static_cast<long long>(c_lo + cr) * v.win;
        const long long first = (row + lo) >> 3;
        const long long el0 = (first + (i - cr * per)) * 8;
        if (el0 >= row + hi) continue;
        if (el0 + 8 <= numel) {
          const uint4 piece = *reinterpret_cast<const uint4*>(src + el0);
          const bf16* vals = reinterpret_cast<const bf16*>(&piece);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const long long pos = el0 + j - row;
            if (pos >= lo && pos < hi) put(cr, static_cast<int>(pos), vals[j]);
          }
        } else {
          for (int j = 0; j < 8 && el0 + j < numel; ++j) {
            const long long pos = el0 + j - row;
            if (pos >= lo && pos < hi) put(cr, static_cast<int>(pos), src[el0 + j]);
          }
        }
      }
    } else {
      const int len = hi - lo, n = (c_hi - c_lo) * len;
      for (int i = threadIdx.x; i < n; i += kFoldThreads) {
        const int cr = i / len, pos = lo + (i - cr * len);
        put(cr, pos, src[base + static_cast<long long>(c_lo + cr) * v.win + pos]);
      }
    }
  }
  __syncthreads();
  const int pieces = cols / 8;
  for (int i = threadIdx.x; i < rows * pieces; i += kFoldThreads) {
    const int m = i / pieces, piece = i - m * pieces;
    if (m0 + m >= v.L) break;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(tile + m * pitch + piece * 8);
    *reinterpret_cast<uint4*>(dst + ((static_cast<size_t>(g) * v.B + b) * v.L + m0 + m) * v.Kc +
                              cc0 + piece * 8) = make_uint4(words[0], words[1], words[2], words[3]);
  }
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// The main kernel.  Block (`tpb` tiles of BM flat rows of the group's B L
// folded rows, group x BN output channels, phase): an implicit GEMM per
// tile with M = flat rows, N = output channels, K = (channel chunk, tap,
// channel) in k-steps of 16.  A stage is `tg` taps x `ck` channels of one
// tile: the A window (flat rows p0 + base + t0 .. p0 + base + t0 + BM + tg -
// 2, which holds the row-shifted A tiles of all its taps) and the B tile
// (tg x BN packed weight rows), each by 16-byte `cp.async` into rows padded
// by 16 bytes (any 8 consecutive rows fall in distinct banks for
// `ldmatrix`).  The block's tiles are one stream of stages through a ring of
// kStages buffers: the copies of the next kStages - 1 stages, the next
// tile's first ones too, fly while this one is multiplied, so a tile's
// epilogue and the next one's first copies overlap.  Warps WM x WN, each MT
// m-tiles of 16 by NT n-tiles of 8; tap t's A fragment is `ldmatrix.x4` at
// rows t + the warp's, B `ldmatrix.x4` of two n-tiles, each k-step's
// fragments loaded one step ahead; `mma.sync.m16n8k16` bf16 with fp32 sums.
// At a tile's last stage the epilogue rounds y (or dX) once to bf16 in a
// shared [BN][BM + 8] tile and stores channels-first, consecutive threads on
// consecutive positions; flat rows past a batch row's outputs are dropped.
template <int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
conv_bf16_kernel(const bf16* __restrict__ xf, const bf16* __restrict__ wp, bf16* __restrict__ out,
                 ConvGeom q, Bf16View v) {
  constexpr int kT = 32 * WM * WN;
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int CP = BM + 8;  // the epilogue tile's row, bf16
  constexpr int PT = kT < BM ? kT : BM;  // epilogue: threads along the positions
  static_assert(kT % PT == 0 && BM % PT == 0, "epilogue threads");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;

  const int r = blockIdx.z;
  const Bf16Phase ph = bf16_phase(q, v, r);
  const int rows = v.B * v.L;
  const int tile0 = blockIdx.x * v.tpb;
  const int n_tiles = min(v.tpb, (rows + BM - 1) / BM - tile0);
  const int o_tiles = (v.OC + BN - 1) / BN;
  const int grp = blockIdx.y / o_tiles, o0 = (blockIdx.y - grp * o_tiles) * BN;
  const bf16* xg = xf + static_cast<size_t>(grp) * rows * v.Kc;
  const bf16* wg = wp + ((static_cast<size_t>(r) * v.G + grp) * v.OC + o0) * v.T * v.Kc;
  const int pitch = v.ck + 8;
  const int a_rows = BM + v.tg - 1;
  const int stage = (a_rows + v.tg * BN) * pitch;
  bf16* epi = smem + kStages * stage;
  const int n_groups = (ph.taps + v.tg - 1) / v.tg;
  const int n_stages = n_groups * (v.Kc / v.ck);  // a tile's
  const int vs = v.ck == 64 ? 3 : v.ck == 32 ? 2 : 1;  // log2 of a row's 16-byte pieces
  const int vm = (1 << vs) - 1;

  // stage gs of the block's stream: stage gs % n_stages of tile gs / n_stages
  auto load = [&](int gs, int buf) {
    const int tile = gs / n_stages, s = gs - tile * n_stages;
    const int chunk = s / n_groups, t0 = (s - chunk * n_groups) * v.tg;
    const int tn = min(v.tg, ph.taps - t0), c0 = chunk * v.ck;
    bf16* as = smem + buf * stage;
    bf16* bs = as + a_rows * pitch;
    const int row0 = (tile0 + tile) * BM + ph.base + t0;
    const int an = (BM + tn - 1) << vs;
    for (int i = tid; i < an; i += kT) {
      const int row = i >> vs, piece = i & vm;
      const bool ok = row0 + row < rows;
      cp_async16(as + row * pitch + piece * 8,
                 ok ? xg + static_cast<size_t>(row0 + row) * v.Kc + c0 + piece * 8 : xg, ok);
    }
    const int bn = (tn * BN) << vs;
    for (int i = tid; i < bn; i += kT) {
      const int rr = i >> vs, piece = i & vm;
      const int t = rr / BN, n = rr - t * BN;
      const bool ok = o0 + n < v.OC;
      cp_async16(bs + rr * pitch + piece * 8,
                 ok ? wg + (static_cast<size_t>(n) * v.T + t0 + t) * v.Kc + c0 + piece * 8 : wp,
                 ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // ldmatrix row addresses: A lane l -> row l % 16, column 8 (l / 16); B (x4,
  // two n-tiles) lane l -> n (l % 8) + 8 (l / 16), column 8 ((l / 8) % 2),
  // whose lanes 0-15 are also the x2 load's
  const int a_off = (wm * MT * 16 + (lane & 15)) * pitch + (lane >> 4) * 8;
  const int b_off = (wn * NT * 8 + (lane & 7) + ((lane >> 4) << 3)) * pitch + ((lane >> 3) & 1) * 8;
  const int kq = vs - 1;  // log2 of a stage row's k-steps of 16

  // a stage's k-steps, tap-major: k-step ks is tap ks >> kq, columns
  // 16 (ks & (2^kq - 1)); each step's fragments are loaded one step ahead
  auto compute = [&](int s, int buf) {
    const int t0 = (s % n_groups) * v.tg;
    const int steps = min(v.tg, ph.taps - t0) << kq;
    const bf16* as = smem + buf * stage + a_off;
    const bf16* bs = smem + buf * stage + a_rows * pitch + b_off;
    uint32_t a[2][MT][4], b[2][NT][2];
    auto frags = [&](int ks, int f) {
      const int t = ks >> kq, kk = (ks & ((1 << kq) - 1)) * 16;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[f][mt], as + (t + mt * 16) * pitch + kk);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r4[4];
        ldmatrix_x4(r4, bs + (t * BN + np * 16) * pitch + kk);
        b[f][2 * np][0] = r4[0];
        b[f][2 * np][1] = r4[1];
        b[f][2 * np + 1][0] = r4[2];
        b[f][2 * np + 1][1] = r4[3];
      }
      if constexpr (NT % 2 == 1)
        ldmatrix_x2(b[f][NT - 1], bs + (t * BN + (NT - 1) * 8) * pitch + kk);
    };
    auto products = [&](int f) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[f][mt], b[f][nt][0], b[f][nt][1]);
    };
    frags(0, 0);
#pragma unroll 1
    for (int ks = 0; ks + 1 < steps; ks += 2) {
      frags(ks + 1, 1);
      products(0);
      if (ks + 2 < steps) frags(ks + 2, 0);
      products(1);
    }
    if (steps & 1) products(0);
  };

  // tile `tile` of the block: the accumulators rounded once to bf16 through
  // the epilogue tile, stored channels-first, then zeroed
  const int ow = v.dx ? q.W : q.Wout, ps = v.dx ? q.s : 1;
  auto epilogue = [&](int tile) {
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wm * MT * 16 + mt * 16 + g8 + 8 * (e >> 1);
          const int col = wn * NT * 8 + nt * 8 + 2 * t4 + (e & 1);
          epi[col * CP + row] = __float2bfloat16_rn(acc[mt][nt][e]);
          acc[mt][nt][e] = 0.0f;
        }
    __syncthreads();
    for (int i = tid % PT; i < BM; i += PT) {
      const int p = (tile0 + tile) * BM + i;
      const int bb = p / v.L, pos = p - bb * v.L;
      if (p >= rows || pos >= ph.nout) continue;
      bf16* dst = out + ((static_cast<size_t>(bb) * v.G + grp) * v.OC + o0) * ow + pos * ps + r;
      for (int o = tid / PT; o < BN && o0 + o < v.OC; o += kT / PT)
        dst[static_cast<size_t>(o) * ow] = epi[o * CP + i];
    }
  };

  if (n_stages == 0) {  // a dX phase no tap reaches: zeros
    for (int tile = 0; tile < n_tiles; ++tile) {
      epilogue(tile);
      __syncthreads();
    }
    return;
  }
  // one barrier a stage: after it, this stage's copies have landed for every
  // thread and the buffer of the stage before is free for a new copy; the
  // epilogue tile is rewritten only after the next stage's barrier
  const int total = n_tiles * n_stages;
#pragma unroll
  for (int gs = 0; gs < kStages - 1; ++gs) {
    if (gs < total) load(gs, gs);
    cp_async_commit();
  }
  for (int gs = 0; gs < total; ++gs) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (gs + kStages - 1 < total) load(gs + kStages - 1, (gs + kStages - 1) % kStages);
    cp_async_commit();
    const int s = gs % n_stages;
    compute(s, gs % kStages);
    if (s == n_stages - 1) epilogue(gs / n_stages);
  }
}

// the main kernel's epilogue tile, bytes
constexpr int bf16_epi_bytes(int bm, int bn) { return 2 * bn * (bm + 8); }

// Channels and taps a stage of the main kernel holds: of the chunk sizes 64,
// 32, 16 that divide Kc, with the taps split into groups as even as the
// budget (kStages stages and the epilogue tile in what two blocks a SM may
// have) allows, the one that copies the fewest window elements into shared
// memory (the weights are copied once whatever the split), counting 2048
// elements for each stage's barrier.
bool bf16_stages(Bf16View& v, int bm, int bn) {
  const int budget = (static_cast<int>(kTwoBlockSmem) - bf16_epi_bytes(bm, bn)) / kStages;
  long long best = -1;
  for (int ck = 64; ck >= 16; ck /= 2) {
    if (v.Kc % ck) continue;
    const int pitch = ck + 8;
    const int tmax = min(v.T, (budget / (2 * pitch) - bm + 1) / (1 + bn));
    if (tmax < 1) continue;
    const int groups = (v.T + tmax - 1) / tmax;
    const int tg = (v.T + groups - 1) / groups;
    const long long cost =
        static_cast<long long>(v.Kc / ck) * groups * ((bm + tg - 1) * ck + 2048);
    if (best < 0 || cost < best) {
      best = cost;
      v.ck = ck;
      v.tg = tg;
    }
  }
  return best >= 0;
}

template <int MT, int NT, int WM, int WN>
int launch_conv_bf16(const bf16* xf, const bf16* wp, bf16* out, const ConvGeom& q, Bf16View v,
                     cudaStream_t stream) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  if (!bf16_stages(v, BM, BN)) return cudaErrorInvalidValue;
  const size_t stage = static_cast<size_t>(BM + v.tg - 1 + v.tg * BN) * (v.ck + 8);
  const size_t smem = 2 * kStages * stage + bf16_epi_bytes(BM, BN);
  const long long m_tiles = (static_cast<long long>(v.B) * v.L + BM - 1) / BM;
  const long long grid_y = static_cast<long long>(v.G) * ((v.OC + BN - 1) / BN);
  if (smem > kMaxSmem || m_tiles > 0x7fffffff || grid_y > 65535 || v.phases > 65535)
    return cudaErrorInvalidValue;
  // tiles a block walks: enough blocks for about kBf16Waves waves of two
  // blocks a SM, no more tiles a block than that leaves
  const long long others = grid_y * v.phases;
  const long long slots = 2LL * kBf16Sms * kBf16Waves;
  v.tpb = static_cast<int>(std::max(1LL, m_tiles * others / slots));
  const long long grid_x = (m_tiles + v.tpb - 1) / v.tpb;
  auto kernel = conv_bf16_kernel<MT, NT, WM, WN>;
  // once an instance: the most any launch asks for (the chooser's budget)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kTwoBlockSmem));
  if (attr != cudaSuccess) return attr;
  if (smem > kTwoBlockSmem) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y), v.phases);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(xf, wp, out, q, v);
  return cudaGetLastError();
}

// The layout pass of `in` (a view's channels-first input) into `out`; the
// grid's z is G x B, at most 65535 (the callers check).
cudaError_t launch_fold(const bf16* in, bf16* out, const Bf16View& v, cudaStream_t stream) {
  const long long z = static_cast<long long>(v.G) * v.B;
  const int rows = fold_rows(v.Kc);
  const dim3 grid((v.L + rows - 1) / rows, (v.Kc + kFoldCols - 1) / kFoldCols,
                  static_cast<unsigned>(z));
  const long long numel = z * v.C * v.win;
  const int vec = aligned16(in);
  switch (v.st) {
    case 1: fold_bf16_kernel<1><<<grid, kFoldThreads, 0, stream>>>(in, out, v, numel, vec); break;
    case 2: fold_bf16_kernel<2><<<grid, kFoldThreads, 0, stream>>>(in, out, v, numel, vec); break;
    case 4: fold_bf16_kernel<4><<<grid, kFoldThreads, 0, stream>>>(in, out, v, numel, vec); break;
    default: fold_bf16_kernel<0><<<grid, kFoldThreads, 0, stream>>>(in, out, v, numel, vec);
  }
  return cudaGetLastError();
}

// One bf16 K3 call: pack the weights and fold the input into `workspace`,
// then run the main kernel.  Output channels per block: 8, 16 or 32 (8 warps
// along the positions, 256 positions) or 64 (4 x 2 warps, 128 positions).
int run_conv_bf16(const bf16* in, const bf16* w, bf16* out, bf16* workspace, const ConvGeom& q,
                  bool dx, cudaStream_t stream) {
  const Bf16View v = bf16_view(q, dx);
  bf16* xf = workspace;
  bf16* wp = workspace + bf16_fold_elems(v);
  const long long fold_z = static_cast<long long>(v.G) * v.B;
  const size_t pack_smem = 2 * static_cast<size_t>(dx ? q.Og : q.Cg) * q.k;
  if (fold_z > 65535 || v.G > 65535 || v.phases > 65535 || pack_smem > kMaxSmem ||
      static_cast<long long>(v.T) * v.Kc > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (pack_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(pack_w_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(pack_smem));
    if (err != cudaSuccess) return err;
  }
  pack_w_bf16_kernel<<<dim3(v.OC, v.G, v.phases), kPackThreads, pack_smem, stream>>>(w, wp, q, v);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_fold(in, xf, v, stream);
  if (err != cudaSuccess) return err;
  if (v.OC <= 8) return launch_conv_bf16<4, 1, 8, 1>(xf, wp, out, q, v, stream);
  if (v.OC <= 16) return launch_conv_bf16<2, 2, 8, 1>(xf, wp, out, q, v, stream);
  if (v.OC <= 32) return launch_conv_bf16<2, 4, 8, 1>(xf, wp, out, q, v, stream);
  return launch_conv_bf16<2, 4, 4, 2>(xf, wp, out, q, v, stream);
}

// ---------------------------------------------------------------------------
// K4 in bf16: two layout passes, a tensor-core kernel, a reduce-and-unpack pass.

constexpr int kDwBK = 128;                   // flat rows a stage of the main kernel
constexpr int kDwBf16Blocks = 4 * kBf16Sms;  // main kernel: about two waves of two blocks a SM
constexpr int kDwMinStages = 8;              // stages a part walks at the least, where it can

// One bf16 dW call (see the note at the top).  x' is the forward's fold
// (`bf16_view(q, false)`: L = Wout + T - 1 rows a batch row, Kx = Cg s
// rounded up to 16 channels), dy' the fold of dy to the same rows (C = Og,
// st 1, off 0: dy'[g][b L + n][o] = dy[b][g Og + o][n], zero at n >= Wout):
//   dWf[g][o][t][cf] = sum over flat rows p < B L of dy'[g][p][o] x'[g][p + t][cf],
// dw[g Og + o][c][t s + ph] = dWf[g][o][t][c s + ph].  Flat row p = b L + n
// with n < Wout meets x' rows n + t < L of its own batch row; dy' is zero on
// the rows n >= Wout, so the halo rows between batch rows add nothing.
// A block of the main kernel owns `tg` taps x 16 `cq` folded channels of x'
// (its `mb` m-tiles of 16, tap-major) by `bn` output channels, over the
// stages (kDwBK flat rows each) of one part.
struct DwBf16Plan {
  int ok;
  Bf16View xv, dv;       // the folds of x and dy
  int T, Og, Kx, Kd;     // taps, output channels a group, folded channels of x' and dy'
  int mb, bn;            // the main kernel's m-tiles and output channels a block
  int cq, tg, tgroups;   // 16-channel chunks and taps a block; blocks along the taps
  int chunks;            // blocks along x's folded channels
  int per_part, parts;   // stages a part; parts
};

// The main kernel's m-tiles and output channels a block by the group's
// output channels (its instances, `run_dw_bf16`), then the block's channels
// and taps: of the chunk counts 4, 2, 1 that divide Kx / 16, with the taps
// split into groups as even as mb / cq allows, the one of least cost,
// counting for each block its m-tile slots (whether a tap fills them or not:
// a warp's slots past the taps idle) at 16 kDwBK elements and the elements
// it stages.  Then the parts: enough blocks for kDwBf16Blocks, each part at
// least kDwMinStages stages where the rows allow.  All of it depends on the
// shape alone.
DwBf16Plan dw_bf16_plan(const ConvGeom& q) {
  DwBf16Plan P{};
  P.xv = bf16_view(q, false);
  P.T = P.xv.T;
  P.Og = q.Og;
  P.Kx = P.xv.Kc;
  P.Kd = (q.Og + 15) / 16 * 16;
  P.dv = P.xv;
  P.dv.C = q.Og; P.dv.win = q.Wout; P.dv.st = 1; P.dv.off = 0; P.dv.pl = 0; P.dv.Kc = P.Kd;
  if (q.Og <= 16) { P.mb = 32; P.bn = 16; }
  else if (q.Og <= 32) { P.mb = 32; P.bn = 32; }
  else { P.mb = 16; P.bn = 64; }
  long long best = -1;
  for (int cq = 4; cq >= 1; cq /= 2) {
    if ((P.Kx / 16) % cq) continue;
    const int tmax = P.mb / cq;
    const int groups = (P.T + tmax - 1) / tmax, tg = (P.T + groups - 1) / groups;
    const long long blocks = static_cast<long long>(groups) * (P.Kx / (16 * cq));
    const long long cost = blocks * (16LL * kDwBK * P.mb + 16LL * cq * (kDwBK + tg - 1) +
                                     static_cast<long long>(kDwBK) * P.bn);
    if (best < 0 || cost < best) {
      best = cost;
      P.cq = cq;
      P.tg = tg;
      P.tgroups = groups;
      P.chunks = P.Kx / (16 * cq);
    }
  }
  const long long rows = static_cast<long long>(q.B) * P.xv.L;
  const long long stages = (rows + kDwBK - 1) / kDwBK;
  const long long n_tiles = (q.Og + P.bn - 1) / P.bn;
  const long long base = static_cast<long long>(P.tgroups) * P.chunks * q.G * n_tiles;
  long long parts = (kDwBf16Blocks + base - 1) / base;
  parts = std::min(parts, std::max(1LL, stages / kDwMinStages));
  const long long per = (stages + parts - 1) / parts;
  P.per_part = static_cast<int>(per);
  P.parts = static_cast<int>((stages + per - 1) / per);  // no empty part
  P.ok = rows + kDwBK + P.T < 0x7fffffff && static_cast<long long>(q.G) * q.B <= 65535 &&
         q.G * n_tiles <= 65535 && P.parts <= 65535 &&
         4LL * q.Cg * q.k <= static_cast<long long>(kMaxSmem);
  return P;
}

size_t dw_bf16_parts_elems(const DwBf16Plan& P) {
  return static_cast<size_t>(P.parts) * P.xv.G * P.Og * P.T * P.Kx;
}

size_t dw_bf16_workspace_bytes(const DwBf16Plan& P) {
  return 2 * (bf16_fold_elems(P.xv) + bf16_fold_elems(P.dv)) + 4 * dw_bf16_parts_elems(P);
}

// The main kernel.  Block (tap group x channel chunk, group x BN output
// channels, part): an implicit GEMM with M = (tap, folded channel) pairs,
// N = output channels, K = the part's flat rows in k-steps of 16.  A stage
// is kDwBK flat rows p0 ..: the x' window of rows p0 + t0 .. p0 + t0 +
// kDwBK + tg - 2 (the row-shifted A tiles of all the block's taps) for its
// 16 cq channels, and the dy' rows p0 .. p0 + kDwBK - 1 for its output
// channels, each by 16-byte `cp.async` with zero fill past B L into rows
// padded by 16 bytes (any 8 consecutive rows in distinct banks), in a ring
// of kStages buffers, the next two stages' copies in flight under this
// one's products.  Warps WM x WN, each MT m-tiles by NT n-tiles of 8; K runs
// along the staged rows, so A (m-tile i: tap ti, channels 16 ci ..) is
// `ldmatrix.x4.trans` at window rows ti + the k-step's, and B
// `ldmatrix.x4.trans` of two n-tiles of dy' rows; `mma.sync.m16n8k16` bf16
// with fp32 sums (products of bf16 values are exact).  A warp's m-tiles past
// the block's taps are skipped.  The sums go to the part's slice of the
// workspace, parts[part][g][o][t][cf] (fp32); no atomics.
template <int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
dw_bf16_kernel(const bf16* __restrict__ xf, const bf16* __restrict__ dyf,
               float* __restrict__ parts_out, DwBf16Plan P) {
  constexpr int kT = 32 * WM * WN;
  constexpr int BN = WN * NT * 8;
  constexpr int BP = BN + 8;  // a staged dy' row, bf16
  constexpr int pieces = BN / 8;
  static_assert(NT % 2 == 0, "B fragments come two n-tiles a load");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;

  const int rows = P.xv.B * P.xv.L;
  const int tgi = blockIdx.x / P.chunks;
  const int c0 = (blockIdx.x - tgi * P.chunks) * 16 * P.cq;
  const int t0 = tgi * P.tg, tn = min(P.tg, P.T - t0);
  const int n_tiles = (P.Og + BN - 1) / BN;
  const int grp = blockIdx.y / n_tiles, n0 = (blockIdx.y - grp * n_tiles) * BN;
  const int first = blockIdx.z * P.per_part;
  const int n_stages = min(P.per_part, (rows + kDwBK - 1) / kDwBK - first);
  const int ap = 16 * P.cq + 8;  // a staged x' row, bf16
  const int a_rows = kDwBK + P.tg - 1;
  const int stage = a_rows * ap + kDwBK * BP;
  const int vs = P.cq == 4 ? 3 : P.cq;  // log2 of a window row's 16-byte pieces
  const bf16* xg = xf + static_cast<size_t>(grp) * rows * P.Kx;
  const bf16* dg = dyf + static_cast<size_t>(grp) * rows * P.Kd;
  // m-tile i of this warp is the block's m-tile wm MT + i: tap (wm MT + i) /
  // cq, channel chunk (wm MT + i) % cq; those below `live` hold a tap
  const int live = min(MT, max(0, tn * P.cq - wm * MT));

  auto load = [&](int ls, int buf) {
    const int p0 = (first + ls) * kDwBK;
    bf16* as = smem + buf * stage;
    bf16* bs = as + a_rows * ap;
    const int an = (kDwBK + tn - 1) << vs, vm = (1 << vs) - 1;
    for (int i = tid; i < an; i += kT) {
      const int r = i >> vs, piece = i & vm;
      const int row = p0 + t0 + r;
      const bool ok = row < rows;
      cp_async16(as + r * ap + piece * 8,
                 ok ? xg + static_cast<size_t>(row) * P.Kx + c0 + piece * 8 : xf, ok);
    }
    for (int i = tid; i < kDwBK * pieces; i += kT) {
      const int r = i / pieces, piece = i - r * pieces;
      const int col = n0 + piece * 8;
      const bool ok = p0 + r < rows && col < P.Kd;
      cp_async16(bs + r * BP + piece * 8,
                 ok ? dg + static_cast<size_t>(p0 + r) * P.Kd + col : dyf, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.0f;

  // ldmatrix.trans row addresses, K along the staged rows: A lane l -> row
  // (l % 8) + 8 (l / 16), column 8 ((l / 8) % 2) of its 16 x 16 tile; B lane
  // l -> row (l % 8) + 8 ((l / 8) % 2), column 8 (l / 16) of two n-tiles
  int a_off[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mi = wm * MT + i;
    a_off[i] = (mi / P.cq + (lane & 7) + ((lane >> 4) << 3)) * ap + (mi % P.cq) * 16 +
               (((lane >> 3) & 1) << 3);
  }
  const int b_off =
      ((lane & 7) + (((lane >> 3) & 1) << 3)) * BP + wn * NT * 8 + ((lane >> 4) << 3);

  auto compute = [&](int buf) {
    const bf16* as = smem + buf * stage;
    const bf16* bs = as + a_rows * ap + b_off;
#pragma unroll
    for (int ks = 0; ks < kDwBK / 16; ++ks) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (i < live) ldmatrix_x4_trans(a[i], as + a_off[i] + ks * 16 * ap);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, bs + ks * 16 * BP + np * 16);
        b[2 * np][0] = r4[0];
        b[2 * np][1] = r4[1];
        b[2 * np + 1][0] = r4[2];
        b[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (i < live)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[i][nt], a[i], b[nt][0], b[nt][1]);
    }
  };

  // one barrier a stage: after it, this stage's copies have landed for every
  // thread and the buffer of the stage before is free for a new copy
#pragma unroll
  for (int gs = 0; gs < kStages - 1; ++gs) {
    if (gs < n_stages) load(gs, gs);
    cp_async_commit();
  }
  for (int gs = 0; gs < n_stages; ++gs) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (gs + kStages - 1 < n_stages) load(gs + kStages - 1, (gs + kStages - 1) % kStages);
    cp_async_commit();
    if (live > 0) compute(gs % kStages);
  }

  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t m_len = static_cast<size_t>(P.T) * P.Kx;
  float* dst = parts_out + (static_cast<size_t>(blockIdx.z) * P.xv.G + grp) * P.Og * m_len;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= live) continue;
    const int mi = wm * MT + i;
    const size_t m0 = static_cast<size_t>(t0 + mi / P.cq) * P.Kx + c0 + (mi % P.cq) * 16 + g8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = n0 + wn * NT * 8 + nt * 8 + 2 * t4 + (e & 1);
        if (o < P.Og) dst[o * m_len + m0 + 8 * (e >> 1)] = acc[i][nt][e];
      }
  }
}

// The reduce-and-unpack pass: a block per output channel g Og + o.  Its
// threads walk the part slices' row (g, o) in order, (t, cf), adding the
// parts in part order (their loads issued eight at a time), and put each
// sum at (c, t s + ph) (cf = c s + ph) of the dw row in shared memory,
// dropping cf >= Cg s and t s + ph >= k; then the row (Cg k floats) is
// written out whole: reads and writes in order.
constexpr int kUnpackThreads = 512;

__global__ void __launch_bounds__(kUnpackThreads)
dw_unpack_bf16_kernel(const float* __restrict__ parts_in, float* __restrict__ dw, ConvGeom q,
                      DwBf16Plan P) {
  extern __shared__ float dw_row[];
  const size_t oc = blockIdx.x;  // g Og + o
  const int m_len = P.T * P.Kx;
  const size_t per = static_cast<size_t>(q.G) * q.Og * m_len;
  for (int i = threadIdx.x; i < m_len; i += kUnpackThreads) {
    const int t = i / P.Kx, cf = i - t * P.Kx;
    const int c = cf / q.s, j = t * q.s + (cf - c * q.s);
    if (c >= q.Cg || j >= q.k) continue;
    const float* src = parts_in + oc * m_len + i;
    float sum = 0.0f;
    for (int p = 0; p < P.parts; p += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = p + u < P.parts ? src[(p + u) * per] : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (p + u < P.parts) sum += v[u];
    }
    dw_row[c * q.k + j] = sum;
  }
  __syncthreads();
  float* dst = dw + oc * q.Cg * q.k;
  for (int i = threadIdx.x; i < q.Cg * q.k; i += kUnpackThreads) dst[i] = dw_row[i];
}

template <int MT, int NT, int WM, int WN>
cudaError_t launch_dw_bf16(const bf16* xf, const bf16* dyf, float* parts, const ConvGeom& q,
                           const DwBf16Plan& P, cudaStream_t stream) {
  constexpr int BN = WN * NT * 8;
  if (WM * MT != P.mb || BN != P.bn) return cudaErrorInvalidValue;
  const size_t stage = static_cast<size_t>(kDwBK + P.tg - 1) * (16 * P.cq + 8) +
                       static_cast<size_t>(kDwBK) * (BN + 8);
  const size_t smem = 2 * kStages * stage;
  auto kernel = dw_bf16_kernel<MT, NT, WM, WN>;
  // once an instance: what two blocks a SM may have, the most a launch asks for
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kTwoBlockSmem));
  if (attr != cudaSuccess) return attr;
  if (smem > kTwoBlockSmem) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(P.tgroups * P.chunks),
                  static_cast<unsigned>(q.G * ((q.Og + BN - 1) / BN)), P.parts);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(xf, dyf, parts, P);
  return cudaGetLastError();
}

// One bf16 dW call: fold x and dy into `workspace`, run the main kernel into
// the parts after them, then add the parts and unpack into dw.  Tiles a
// block: 32 m-tiles by 16 output channels (8 warps along M, 4 x 2 tiles a
// warp), 32 by 32 (4 x 4), or 16 by 64 (4 x 2 warps, 4 x 4 tiles a warp).
int run_dw_bf16(const bf16* x, const bf16* dy, float* dw, void* workspace, const ConvGeom& q,
                cudaStream_t stream) {
  const DwBf16Plan P = dw_bf16_plan(q);
  if (!P.ok) return cudaErrorInvalidValue;
  bf16* xf = static_cast<bf16*>(workspace);
  bf16* dyf = xf + bf16_fold_elems(P.xv);
  float* parts = reinterpret_cast<float*>(dyf + bf16_fold_elems(P.dv));
  cudaError_t err = launch_fold(x, xf, P.xv, stream);
  if (err != cudaSuccess) return err;
  err = launch_fold(dy, dyf, P.dv, stream);
  if (err != cudaSuccess) return err;
  if (P.bn == 16) err = launch_dw_bf16<4, 2, 8, 1>(xf, dyf, parts, q, P, stream);
  else if (P.bn == 32) err = launch_dw_bf16<4, 4, 8, 1>(xf, dyf, parts, q, P, stream);
  else err = launch_dw_bf16<4, 4, 4, 2>(xf, dyf, parts, q, P, stream);
  if (err != cudaSuccess) return err;
  const size_t row = 4 * static_cast<size_t>(q.Cg) * q.k;
  if (row > 48 * 1024) {
    err = cudaFuncSetAttribute(dw_unpack_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(row));
    if (err != cudaSuccess) return err;
  }
  dw_unpack_bf16_kernel<<<static_cast<unsigned>(q.G * q.Og), kUnpackThreads, row, stream>>>(
      parts, dw, q, P);
  return cudaGetLastError();
}

ConvGeom make_geom(int B, int Cin, int W, int Cout, int k, int s, int pad, int G, int Wout) {
  ConvGeom q;
  q.B = B; q.G = G; q.Cg = G > 0 ? Cin / G : 0; q.Og = G > 0 ? Cout / G : 0;
  q.W = W; q.Wout = Wout; q.k = k; q.s = s; q.pad = pad;
  return q;
}

// Every entry returns the CUDA error of its launch (0 on success) and 1
// (cudaErrorInvalidValue) for sizes the kernels do not take.  All tensors are
// contiguous: x [B, Cin, W], w [Cout, Cin/G, k], y and dy [B, Cout, Wout],
// fp32 or (the `_bf16` entries) bf16; dW and its workspace are fp32 in both.

template <bool DX>
int conv_entry(const void* in, const void* w, void* out, int B, int Cin, int W, int Cout, int k,
               int s, int pad, int G, int Wout, void* stream) {
  if (G < 1 || Cin % G || Cout % G) return cudaErrorInvalidValue;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q)) return cudaErrorInvalidValue;
  return dispatch_conv_mma<DX>(in, w, out, q, static_cast<cudaStream_t>(stream));
}

template <bool DX>
int conv_bf16_entry(const void* in, const void* w, void* out, void* workspace, int B, int Cin,
                    int W, int Cout, int k, int s, int pad, int G, int Wout, void* stream) {
  if (G < 1 || Cin % G || Cout % G || workspace == nullptr || !aligned16(workspace))
    return cudaErrorInvalidValue;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q)) return cudaErrorInvalidValue;
  return run_conv_bf16(static_cast<const bf16*>(in), static_cast<const bf16*>(w),
                       static_cast<bf16*>(out), static_cast<bf16*>(workspace), q, DX,
                       static_cast<cudaStream_t>(stream));
}

int dw_entry(const void* x, const void* dy, void* dw, void* workspace, int B, int Cin, int W,
             int Cout, int k, int s, int pad, int G, int Wout, int parts, void* stream) {
  if (G < 1 || Cin % G || Cout % G) return cudaErrorInvalidValue;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q) || parts != dw_parts(q) || (parts > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* dyp = static_cast<const float*>(dy);
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

int dw_bf16_entry(const void* x, const void* dy, void* dw, void* workspace, int B, int Cin, int W,
                  int Cout, int k, int s, int pad, int G, int Wout, void* stream) {
  if (G < 1 || Cin % G || Cout % G || workspace == nullptr || !aligned16(workspace))
    return cudaErrorInvalidValue;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q)) return cudaErrorInvalidValue;
  return run_dw_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                     static_cast<float*>(dw), workspace, q, static_cast<cudaStream_t>(stream));
}

}  // namespace

#define ROAR_CONV_ENTRY(NAME, DX)                                                              \
  extern "C" int NAME(const void* in, const void* w, void* out, int B, int Cin, int W,       \
                      int Cout, int k, int s, int pad, int G, int Wout, void* stream) {      \
    return conv_entry<DX>(in, w, out, B, Cin, W, Cout, k, s, pad, G, Wout, stream);          \
  }
ROAR_CONV_ENTRY(roar_grouped_conv_fwd, false)
ROAR_CONV_ENTRY(roar_grouped_conv_dx, true)
#undef ROAR_CONV_ENTRY

// bf16 forward (in = x, out = y) and dX (in = dy, out = dx): `workspace` holds
// the folded input and the packed weights, `roar_grouped_conv_bf16_workspace`
// bytes, 16-byte aligned
#define ROAR_CONV_BF16_ENTRY(NAME, DX)                                                         \
  extern "C" int NAME(const void* in, const void* w, void* out, void* workspace, int B,      \
                      int Cin, int W, int Cout, int k, int s, int pad, int G, int Wout,      \
                      void* stream) {                                                        \
    return conv_bf16_entry<DX>(in, w, out, workspace, B, Cin, W, Cout, k, s, pad, G, Wout,   \
                               stream);                                                      \
  }
ROAR_CONV_BF16_ENTRY(roar_grouped_conv_fwd_bf16, false)
ROAR_CONV_BF16_ENTRY(roar_grouped_conv_dx_bf16, true)
#undef ROAR_CONV_BF16_ENTRY

// Bytes of the workspace a bf16 forward (dx = 0) or dX (dx = 1) call needs; 0
// for sizes the kernels do not take.
extern "C" long long roar_grouped_conv_bf16_workspace(int dx, int B, int Cin, int W, int Cout,
                                                      int k, int s, int pad, int G, int Wout) {
  if (G < 1 || Cin % G || Cout % G) return 0;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q)) return 0;
  return static_cast<long long>(bf16_workspace_bytes(bf16_view(q, dx != 0)));
}

// Number of parts the fp32 weight gradient splits batch x width into; the
// caller allocates a workspace of parts * Cout * Cin/G * k floats when it is
// > 1.
extern "C" int roar_grouped_conv_dw_parts(
    int B, int Cin, int W, int Cout, int k, int s, int pad, int G, int Wout) {
  if (G < 1 || Cin % G || Cout % G) return 0;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  return geom_ok(q) ? dw_parts(q) : 0;
}

extern "C" int roar_grouped_conv_dw(
    const void* x, const void* dy, void* dw, void* workspace, int B, int Cin, int W, int Cout,
    int k, int s, int pad, int G, int Wout, int parts, void* stream) {
  return dw_entry(x, dy, dw, workspace, B, Cin, W, Cout, k, s, pad, G, Wout, parts, stream);
}

// Bytes of the workspace a bf16 dW call needs (the two folded inputs and the
// parts); 0 for sizes the kernels do not take.
extern "C" long long roar_grouped_conv_dw_bf16_workspace(int B, int Cin, int W, int Cout, int k,
                                                         int s, int pad, int G, int Wout) {
  if (G < 1 || Cin % G || Cout % G) return 0;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q)) return 0;
  const DwBf16Plan plan = dw_bf16_plan(q);
  return plan.ok ? static_cast<long long>(dw_bf16_workspace_bytes(plan)) : 0;
}

// x and dy bf16, dW fp32 (the TPU kernel's output type); `workspace`:
// `roar_grouped_conv_dw_bf16_workspace` bytes, 16-byte aligned
extern "C" int roar_grouped_conv_dw_bf16(
    const void* x, const void* dy, void* dw, void* workspace, int B, int Cin, int W, int Cout,
    int k, int s, int pad, int G, int Wout, void* stream) {
  return dw_bf16_entry(x, dy, dw, workspace, B, Cin, W, Cout, k, s, pad, G, Wout, stream);
}
