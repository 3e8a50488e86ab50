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
// FLOP per byte, so the bound is the fp32 FMA rate (67 TFLOP/s without
// tensor cores), not device memory.  The design therefore spends its effort
// on FMAs per shared-memory load:
//
// K3 (`conv_tile_kernel`, ONE device routine behind both entry points).  A
//   block of 8 warps owns (batch, group, 8 RO output channels, 32 RN output
//   positions); warp = channel sub-tile, lane = position, each thread an
//   RO x RN register tile (8 x 4 at the production shapes).  The contraction
//   runs over chunks of 4 input channels: the input window and the weight
//   slab of a chunk are staged in shared memory, the window de-interleaved by
//   stride phase so that lanes read consecutive words for any stride, the
//   weights with the output channel fastest so that one 16-byte broadcast
//   load feeds 4 rows of FMAs.  Per tap a thread makes RN + RO/4 loads for
//   RO RN FMAs.  Both ragged edges are masked (zero fill on load, bounds on
//   store); RO and RN are picked per shape so narrow layers (33, 65, 129
//   outputs) pad little.
//   dX is the same routine in another view: for each output phase r = m % s
//   only the taps j = (r + pad) % s + s t contribute, and they form a
//   stride-1 correlation of dy with the reversed sub-sampled weight, so a
//   block takes one (batch, phase) and contracts over the group's output
//   channels; weights are gathered transposed from the same tensor, nothing
//   is packed in device memory.  Tail positions that no tap reaches get 0.
// K4 (`dw_partial_kernel` + `dw_reduce_kernel`).  The TPU kernel carries its
//   sum along a sequential grid axis; blocks here run in no order, and the
//   output (G x Og x Cg k values) alone cannot fill 132 SMs, so the
//   batch x width range is split into `parts`: a block owns (group, 8 RO
//   output channels, 128 (channel, tap) pairs, one part), walks its part in
//   tiles of 64 positions staged in shared memory (dy transposed so that the
//   output channels of one position are one broadcast load), and keeps an
//   RO x 4 register tile for the whole walk.  Partial sums go to a workspace
//   and a second kernel adds them in part order: no float atomics, so two
//   runs give the same bits.
//
// Tensor cores (TF32/bf16 `wgmma`), TMA and async staging are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4;       // K3: contraction channels staged per chunk
constexpr int kPairs = 128;     // K4: (channel, tap) pairs per block
constexpr int kPairRegs = kPairs / 32;
constexpr int kDwTile = 64;     // K4: contraction positions staged per tile
constexpr int kDwTargetBlocks = 4 * 132;
constexpr size_t kMaxSmem = 227 * 1024;

struct ConvGeom {
  int B, G, Cg, Og, W, Wout, k, s, pad;
};

// RO consecutive floats from shared memory, by the widest aligned load.
template <int RO>
__device__ __forceinline__ void load_row(const float* p, float (&v)[RO]) {
  if constexpr (RO % 4 == 0) {
#pragma unroll
    for (int i = 0; i < RO; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (RO == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < RO; ++i) v[i] = p[i];
  }
}

// K3.  DX = false: forward, `in` is x and `out` is y.  DX = true: input
// gradient, `in` is dy and `out` is dx, blockIdx.z = batch * s + phase.
template <int RO, int RN, bool DX>
__global__ void __launch_bounds__(kThreads)
conv_tile_kernel(const float* __restrict__ in, const float* __restrict__ w,
                 float* __restrict__ out, ConvGeom q, int st_shift) {
  extern __shared__ __align__(16) float smem[];
  constexpr int OT = kWarps * RO;   // output channels per block
  constexpr int NT = 32 * RN;       // output positions per block
  constexpr int WS = OT + 4;        // weight row stride: keeps 16-byte alignment, spreads banks
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

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
  const int n0 = blockIdx.x * NT;
  if (n0 >= nout) return;
  const int o_tiles = (oc + OT - 1) / OT;
  const int g = blockIdx.y / o_tiles;
  const int o0 = (blockIdx.y % o_tiles) * OT;

  const int ph_len = NT + (taps + st - 1) / st;  // words per stride phase of the window
  float* w_s = smem;                              // [kChunk * taps][WS]
  float* x_s = smem + kChunk * taps * WS;         // [kChunk][st][ph_len]
  const int xw = (NT - 1) * st + taps;            // window length in input positions
  const int p0 = n0 * st - pd;                    // input position of the window's start
  const float* in_g = in + (static_cast<size_t>(b) * q.G + g) * kc * win;

  float acc[RO][RN];
#pragma unroll
  for (int i = 0; i < RO; ++i)
#pragma unroll
    for (int n = 0; n < RN; ++n) acc[i][n] = 0.0f;

  for (int c0 = 0; c0 < kc; c0 += kChunk) {
    // weights of the chunk: w_s[(cc * taps + j) * WS + o]
    for (int o = warp; o < OT; o += kWarps) {
      const bool o_ok = o0 + o < oc;
#pragma unroll
      for (int cc = 0; cc < kChunk; ++cc) {
        const bool ok = o_ok && c0 + cc < kc;
        for (int j = lane; j < taps; j += 32) {
          float v = 0.0f;
          if (ok) {
            const size_t idx = DX
                ? (static_cast<size_t>(g * q.Og + c0 + cc) * q.Cg + (o0 + o)) * q.k
                      + j0 + q.s * (taps - 1 - j)
                : (static_cast<size_t>(g * q.Og + o0 + o) * q.Cg + (c0 + cc)) * q.k + j;
            v = w[idx];
          }
          w_s[(cc * taps + j) * WS + o] = v;
        }
      }
    }
    // input window of the chunk, split by stride phase: position p0 + i goes
    // to x_s[cc][i % st][i / st]
#pragma unroll
    for (int cc = 0; cc < kChunk; ++cc) {
      const bool c_ok = c0 + cc < kc;
      const float* src = in_g + static_cast<size_t>(c0 + cc) * win;
      for (int i = threadIdx.x; i < xw; i += kThreads) {
        const int p = p0 + i;
        const float v = (c_ok && p >= 0 && p < win) ? src[p] : 0.0f;
        const int ix = st_shift >= 0 ? i >> st_shift : i / st;
        const int ph = i - ix * st;
        x_s[(cc * st + ph) * ph_len + ix] = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int cc = 0; cc < kChunk; ++cc) {
      for (int ph = 0; ph < st; ++ph) {
        // taps j = ph, ph + st, ...: output n reads word n + (j / st) of phase ph
        const float* xp = x_s + (cc * st + ph) * ph_len + lane;
        const float* wp = w_s + (cc * taps + ph) * WS + warp * RO;
#pragma unroll 4
        for (int j = ph; j < taps; j += st) {
          float wv[RO], xv[RN];
          load_row<RO>(wp, wv);
#pragma unroll
          for (int n = 0; n < RN; ++n) xv[n] = xp[32 * n];
#pragma unroll
          for (int i = 0; i < RO; ++i)
#pragma unroll
            for (int n = 0; n < RN; ++n) acc[i][n] = fmaf(wv[i], xv[n], acc[i][n]);
          xp += 1;
          wp += st * WS;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RO; ++i) {
    const int o = o0 + warp * RO + i;
    if (o >= oc) continue;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const int pos = n0 + lane + 32 * n;
      if (pos >= nout) continue;
      if (DX) {
        out[((static_cast<size_t>(b) * q.G + g) * q.Cg + o) * q.W + pos * q.s + r] = acc[i][n];
      } else {
        out[((static_cast<size_t>(b) * q.G + g) * q.Og + o) * q.Wout + pos] = acc[i][n];
      }
    }
  }
}

// K4, first pass.  Block (x: tile of 128 (channel, tap) pairs of the group,
// y: group and output-channel tile, z: part).  Writes
// out[part][g Og + o][c k + j] for its tile.
template <int RO>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ out, ConvGeom q, int items_per_part, int max_channels) {
  extern __shared__ __align__(16) float smem[];
  constexpr int OT = kWarps * RO;
  constexpr int WS = OT + 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int pairs = q.Cg * q.k;
  const int e0 = blockIdx.x * kPairs;
  const int o_tiles = (q.Og + OT - 1) / OT;
  const int g = blockIdx.y / o_tiles;
  const int o0 = (blockIdx.y % o_tiles) * OT;
  const int part = blockIdx.z;

  const int c_lo = e0 / q.k;
  const int c_hi = (min(e0 + kPairs, pairs) - 1) / q.k;
  const int nch = min(c_hi - c_lo + 1, max_channels);
  const int xw = (kDwTile - 1) * q.s + q.k;
  float* dy_s = smem;                 // [kDwTile][WS], output channel fastest
  float* x_s = smem + kDwTile * WS;   // [nch][xw]

  int off[kPairRegs];                 // word of x_s that pair e reads at position 0
#pragma unroll
  for (int i = 0; i < kPairRegs; ++i) {
    const int e = e0 + lane + 32 * i;
    off[i] = 0;
    if (e < pairs) {
      const int c = e / q.k;
      off[i] = (c - c_lo) * xw + (e - c * q.k);
    }
  }

  float acc[RO][kPairRegs];
#pragma unroll
  for (int i = 0; i < RO; ++i)
#pragma unroll
    for (int e = 0; e < kPairRegs; ++e) acc[i][e] = 0.0f;

  const int n_tiles = (q.Wout + kDwTile - 1) / kDwTile;
  const int total = q.B * n_tiles;
  const int first = part * items_per_part;
  const int last = min(first + items_per_part, total);
  for (int item = first; item < last; ++item) {
    const int b = item / n_tiles;
    const int n0 = (item - b * n_tiles) * kDwTile;
    const float* dy_g = dy + (static_cast<size_t>(b) * q.G + g) * q.Og * q.Wout;
    for (int o = warp; o < OT; o += kWarps) {
      const bool o_ok = o0 + o < q.Og;
      const float* src = dy_g + static_cast<size_t>(o0 + o) * q.Wout;
      for (int n = lane; n < kDwTile; n += 32)
        dy_s[n * WS + o] = (o_ok && n0 + n < q.Wout) ? src[n0 + n] : 0.0f;
    }
    const float* x_g = x + ((static_cast<size_t>(b) * q.G + g) * q.Cg + c_lo) * q.W;
    const int p0 = n0 * q.s - q.pad;
    for (int cc = 0; cc < nch; ++cc) {
      const float* src = x_g + static_cast<size_t>(cc) * q.W;
      for (int i = threadIdx.x; i < xw; i += kThreads) {
        const int p = p0 + i;
        x_s[cc * xw + i] = (p >= 0 && p < q.W) ? src[p] : 0.0f;
      }
    }
    __syncthreads();

    const int n_valid = min(kDwTile, q.Wout - n0);
    const float* dp = dy_s + warp * RO;
#pragma unroll 4
    for (int n = 0; n < n_valid; ++n) {
      float dv[RO], xv[kPairRegs];
      load_row<RO>(dp + n * WS, dv);
#pragma unroll
      for (int e = 0; e < kPairRegs; ++e) xv[e] = x_s[off[e] + n * q.s];
#pragma unroll
      for (int i = 0; i < RO; ++i)
#pragma unroll
        for (int e = 0; e < kPairRegs; ++e) acc[i][e] = fmaf(dv[i], xv[e], acc[i][e]);
    }
    __syncthreads();
  }

  const size_t cout = static_cast<size_t>(q.G) * q.Og;
#pragma unroll
  for (int i = 0; i < RO; ++i) {
    const int o = o0 + warp * RO + i;
    if (o >= q.Og) continue;
#pragma unroll
    for (int e = 0; e < kPairRegs; ++e) {
      const int pair = e0 + lane + 32 * e;
      if (pair < pairs)
        out[(part * cout + g * q.Og + o) * pairs + pair] = acc[i][e];
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

int pick_ro(int channels) {
  for (int ro = 1; ro < 8; ro *= 2)
    if (kWarps * ro >= channels) return ro;
  return 8;
}

// RN in {1, 2, 4}: the least padded width, the larger tile on a tie.
int pick_rn(int nout) {
  int best = 4, best_padded = (nout + 127) / 128 * 128;
  for (int rn = 2; rn >= 1; --rn) {
    const int tile = 32 * rn;
    const int padded = (nout + tile - 1) / tile * tile;
    if (padded < best_padded) { best = rn; best_padded = padded; }
  }
  return best;
}

bool geom_ok(const ConvGeom& q) {
  return q.B >= 1 && q.G >= 1 && q.Cg >= 1 && q.Og >= 1 && q.W >= 1 && q.Wout >= 1 &&
         q.k >= 1 && q.s >= 1 && q.pad >= 0 && q.pad < q.k &&
         q.Wout == (q.W + 2 * q.pad - q.k) / q.s + 1 && q.W + 2 * q.pad >= q.k;
}

template <int RO, int RN, bool DX>
int launch_conv_tile(const float* in, const float* w, float* out, const ConvGeom& q,
                     cudaStream_t stream) {
  constexpr int OT = kWarps * RO, NT = 32 * RN, WS = OT + 4;
  const int st = DX ? 1 : q.s;
  const int taps = DX ? (q.k + q.s - 1) / q.s : q.k;  // the most any phase has
  const int oc = DX ? q.Cg : q.Og;
  const int nout = DX ? (q.W + q.s - 1) / q.s : q.Wout;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kChunk) * taps * WS +
       static_cast<size_t>(kChunk) * st * (NT + (taps + st - 1) / st));
  const long long grid_y = static_cast<long long>(q.G) * ((oc + OT - 1) / OT);
  const long long grid_z = static_cast<long long>(q.B) * (DX ? q.s : 1);
  if (smem > kMaxSmem || grid_y > 65535 || grid_z > 65535) return cudaErrorInvalidValue;
  auto kernel = conv_tile_kernel<RO, RN, DX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int st_shift = -1;
  for (int sh = 0; sh < 16; ++sh)
    if ((1 << sh) == st) st_shift = sh;
  const dim3 grid((nout + NT - 1) / NT, static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(grid_z));
  kernel<<<grid, kThreads, smem, stream>>>(in, w, out, q, st_shift);
  return cudaGetLastError();
}

template <bool DX>
int dispatch_conv_tile(const float* in, const float* w, float* out, const ConvGeom& q,
                       cudaStream_t stream) {
  const int ro = pick_ro(DX ? q.Cg : q.Og);
  const int rn = pick_rn(DX ? (q.W + q.s - 1) / q.s : q.Wout);
#define ROAR_CASE(RO_, RN_) \
  if (ro == RO_ && rn == RN_) return launch_conv_tile<RO_, RN_, DX>(in, w, out, q, stream);
  ROAR_CASE(1, 1) ROAR_CASE(1, 2) ROAR_CASE(1, 4)
  ROAR_CASE(2, 1) ROAR_CASE(2, 2) ROAR_CASE(2, 4)
  ROAR_CASE(4, 1) ROAR_CASE(4, 2) ROAR_CASE(4, 4)
  ROAR_CASE(8, 1) ROAR_CASE(8, 2) ROAR_CASE(8, 4)
#undef ROAR_CASE
  return cudaErrorInvalidValue;
}

// Blocks of the first pass without a split, and positions tiles to split.
void dw_shape(const ConvGeom& q, int* base_blocks, int* total_items) {
  const int ot = kWarps * pick_ro(q.Og);
  const int e_tiles = (q.Cg * q.k + kPairs - 1) / kPairs;
  *base_blocks = e_tiles * q.G * ((q.Og + ot - 1) / ot);
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

template <int RO>
int launch_dw(const float* x, const float* dy, float* dw, float* workspace, const ConvGeom& q,
              int parts, cudaStream_t stream) {
  constexpr int OT = kWarps * RO, WS = OT + 4;
  int base, total;
  dw_shape(q, &base, &total);
  const int max_channels = min(q.Cg, (kPairs - 2 + q.k) / q.k + 1);
  const int xw = (kDwTile - 1) * q.s + q.k;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kDwTile) * WS + static_cast<size_t>(max_channels) * xw);
  const long long grid_y = static_cast<long long>(q.G) * ((q.Og + OT - 1) / OT);
  if (smem > kMaxSmem || grid_y > 65535 || parts > 65535) return cudaErrorInvalidValue;
  auto kernel = dw_partial_kernel<RO>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((q.Cg * q.k + kPairs - 1) / kPairs, static_cast<unsigned>(grid_y), parts);
  const int per = (total + parts - 1) / parts;
  kernel<<<grid, kThreads, smem, stream>>>(x, dy, parts > 1 ? workspace : dw, q, per,
                                           max_channels);
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
  return dispatch_conv_tile<false>(static_cast<const float*>(x), static_cast<const float*>(w),
                                   static_cast<float*>(y), q, static_cast<cudaStream_t>(stream));
}

extern "C" int roar_grouped_conv_dx(
    const void* dy, const void* w, void* dx, int B, int Cin, int W, int Cout, int k, int s,
    int pad, int G, int Wout, void* stream) {
  if (G < 1 || Cin % G || Cout % G) return cudaErrorInvalidValue;
  const ConvGeom q = make_geom(B, Cin, W, Cout, k, s, pad, G, Wout);
  if (!geom_ok(q)) return cudaErrorInvalidValue;
  return dispatch_conv_tile<true>(static_cast<const float*>(dy), static_cast<const float*>(w),
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
  switch (pick_ro(q.Og)) {
    case 1: return launch_dw<1>(xp, dyp, dwp, ws, q, parts, st);
    case 2: return launch_dw<2>(xp, dyp, dwp, ws, q, parts, st);
    case 4: return launch_dw<4>(xp, dyp, dwp, ws, q, parts, st);
    default: return launch_dw<8>(xp, dyp, dwp, ws, q, parts, st);
  }
}
