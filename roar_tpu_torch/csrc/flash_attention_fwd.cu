// Segment-masked flash-attention forward, non-causal and causal, fp32 and
// bf16, for Hopper (sm_90a), on the tensor cores.
//
// Replaces: the upstream Pallas TPU kernel
// `jax.experimental.pallas.ops.tpu.flash_attention` with SegmentIds, that
// roar_tpu/models/transformer.py:72 `flash_self_attention` reaches with
// `causal=False` and roar_tpu/models/gpt.py:491 `_causal_flash` with
// `causal=True`.  Query i sees key j only when seg[b, i] == seg[b, j] and,
// with `causal`, j <= i; valid tokens carry id 0 and padding id 1, so pad
// queries see only pad keys, and every query sees at least its own key.
//
// Layout: q, k, v, out are contiguous [B, T, H, D], fp32 or bf16 (see
// flash_attention_common.cuh for the roundings of the bf16 form); seg is
// [B, T] int32.  Four kernels, one contract.  Up to D 64, in bf16 and fp32,
// one block of 4 warps per (64-query tile, head, batch row); warp w owns query
// rows 16 w .. 16 w + 15 whole, so that a row's running max and sum reduce
// within its lane quad and no barrier sits between the two products.  Per
// key tile:
//   S = Q K^T             (fp32 sums; then s = S * scale, masked)
//   p = exp(s - m)        in registers, m the row's running maximum
//   O = O * alpha + P V   (p stays in registers as the A operand)
// so the [T, T] scores never reach device memory.
//
// bf16 up to D 64, `flash_fwd_mma_kernel` (mma.sync m16n8k16, fp32 sums;
// flash_attention_mma.cuh): p's accumulator fragment is rounded to bf16 as
// the A operand of p.v (its row sum taken unrounded); V is read by
// ldmatrix.trans.  K/V tiles of 64 keys are staged by cp.async into a
// double-buffered, swizzled bf16 layout, the next tile's copy overlapping the
// current tile's products; each warp holds its Q rows as A fragments.
//
// bf16 at D 128 and 256, `flash_fwd_wgmma_kernel` (Hopper's wgmma, TMA,
// mbarriers and setmaxnreg; flash_attention_wgmma.cuh): one launch, one block
// of three warpgroups per 128-query tile.  At D 256 a producer warp copies Q once and the K/V
// tiles of 64 keys by TMA into a two-stage ring; two consumer warpgroups of
// 64 rows each form S on wgmma m64n64k16 from shared memory and O += P V on
// wgmma m64n256k16 with p (rounded to bf16) in registers and V read
// transposed from shared memory, the whole row of o (128 fp32 registers a
// thread, 232 a thread after setmaxnreg) in one pass, so S and the softmax
// are formed once.  The mma form it replaced ran two launches a call, each
// forming half of o's columns and recomputing S and the softmax (0.371 /
// 0.377 ms against the wgmma form's 0.157 / 0.154 at (1, 2048, 8, 256)
// causal, NVIDIA H100 80GB HBM3, 700.00 W, `scripts/flash_kernel_times_torch.py`).
// At D 128 the `<128>` specialisation keeps that block and streams K/V
// tiles of 128 keys through a ring of three stages, K and V on barriers of
// their own; a thread's share of o is 64 registers (m64n128k16 for O += P V),
// which leaves room for the next tile's score product to be in flight beside
// the last tile's P V (FA3's intra-warpgroup order), and the two warpgroups
// take turns issuing their products, so each one's softmax runs under
// products.  It replaced `flash_fwd_mma_kernel<128>` (0.754 / 0.766 ms
// against 0.375 / 0.394 at (1, 4096, 32, 128) causal, NVIDIA H100 80GB HBM3,
// 700.00 W, `scripts/flash_kernel_times_torch.py`).
//
// fp32 up to D 64, `flash_fwd_tf32_kernel` (mma.sync m16n8k8 on TF32,
// tf32x3.cuh; tiles, split and permutation: flash_attention_tf32.cuh): every
// fp32 operand is split into TF32 parts, and each k-chunk of 8 forms its
// partial products in a fresh accumulator that one round-to-nearest add puts
// into the fp32 sum (the tensor cores' own sums truncate).  S = Q K^T is
// 3xTF32 (small.big, big.small, big.big).  P V splits V exactly, big + mid +
// low (`mma_4xtf32`, four products): a two-part split keeps 22 of fp32's 24
// bits, and a row that sees a single key must get o = v to the bit, as the
// backward's cancellation dP - delta then reads 1e-6 for every bit lost.  The
// Q tile is staged once and split into big and small halves in shared
// memory; each K/V tile of 32 keys is staged by cp.async and split once (K
// into halves, V into big half and unrounded rest), read as B operands by all
// four warps.  Each 8-key n-tile of the score accumulator is the split A
// fragment of one k-chunk of P V through the permuted contraction index
// (`acc_as_a`; V rows read by `load_bt`): p is not rounded to a narrower type,
// and the row sum is taken from the same p.  p = exp2((s - m) * log2 e): the
// row's largest element gets exactly 1.  Shared memory, two 64-row and four
// 32-row tiles of D + 4 words: 68 KB at D 64, three blocks a SM (with 64-key
// tiles two fit, and the kernel ran 12 to 16 % slower at (1, 4096, 32, 64)
// causal on an H100); one stage, so each block's copies wait for its
// products and the other blocks' overlap them.
//
// fp32 at D 128 and 256, `flash_fwd_tf32_split_kernel`: the same arithmetic
// in the layout of the backward's dQ split kernel.  A whole row of o is 64 /
// 128 fp32 accumulators a thread at D 128 / 256, and the 4-warp layout with
// it took 168 / 255 registers, one K/V stage and one block of 4 warps a SM.
// Here one block of 8 warps per 64-query tile; the two warps of a 16-row
// group each own half of o's columns (32 / 64 accumulators) and form the
// half of each score tile that their half of Q's and K's columns gives, and
// add the halves in fp32 across shared memory in one fixed order, so S, m, l
// and p are formed once and both warps hold them bit for bit.  K and V are
// staged raw by cp.async, and every one of their operand words is split as
// its fragment is loaded, so the next tile's copy runs under this tile's
// products.  At D 256 Q stays resident unsplit (split as loaded), K and V
// come in two stages of 16 keys (141,312 B); at D 128 Q is split once into
// halves, K and V come in three stages of 32 keys, and the groups of rows
// 32 .. 63 add each tile's P V at the start of the next tile, so that the
// two warps a scheduler holds are in different phases (185,344 B).  S's sum
// over D in two halves moves o and lse by the last bits against the
// whole-row order it replaced, within the fp32 bars
// (`tests/test_torch_flash_tf32.py` emulates both walks).  At (1, 2048, 8,
// 256) causal it takes 0.903 / 0.908 ms where the form it replaced took
// 1.481 / 1.519 in turns with it (11.5 % of its 0.104 ms bound; SDPA in fp32
// 0.615 to 0.656); at (1, 4096, 32, 128) causal 4.139 / 4.173 ms against
// the 4-warp form's 7.717 / 7.842 (20.0 % of its 0.834 ms bound; SDPA in
// fp32 3.21 to 3.30; NVIDIA H100 80GB HBM3, 700.00 W,
// `scripts/flash_kernel_times_torch.py`).
//
// What bounds them on the H100: the two products, 4 B H pairs D operations
// (pairs: the visible (query, key) pairs per head), against the 989 TFLOP/s
// dense bf16 peak, or in fp32 three TF32 products each against 494.7 / 3 =
// 165 TFLOP/s (the bound counts three for P V too, not the four it takes);
// and, at D 64, as much again in per-element softmax work on the FMA and SFU
// pipes (scale, mask, max, exp, row sum, rescale of o), with the splits and
// flush adds beside it in fp32.  What holds them back from it: up to D 64
// and in fp32, `mma.sync` rather than `wgmma`, every warp reading the whole
// staged K/V tile from shared memory (16 rows a warp), cp.async rather than
// TMA; in the fp32 split form also two warps a scheduler, a barrier of the
// two warps of a group between S and the softmax, and (at D 256) Q's
// fragments read and split again for every key tile: its time follows its
// count of mma.sync products as the backward's dQ split kernel's does (224
// against 288 a warp per 16 keys, 0.90 against 1.13 to 1.24 ms), and neither
// 16 warps nor splitting K and V once a tile moved it.  At D 128 it forms
// its products at 114 TFLOP/s, 68 % of what chains of three and four
// products into a fresh accumulator reach at 8 warps a SM alone (141 and
// 193 TFLOP/s; 215 for independent products, 262 at 16 warps;
// `scripts/mma_tf32_rate_torch.py`): the 3xTF32 chains' latency with two
// warps a scheduler.  In the wgmma form at D 256, one
// block a SM (197 KB of shared memory), each warpgroup's softmax waiting on
// its S product and its P V product on the softmax (the D 128 form overlaps
// them, FA3's way; at (1, 4096, 32, 128) causal it reaches 35 to 37 % of
// its bound, NVIDIA H100 80GB HBM3, 700.00 W,
// `scripts/flash_kernel_times_torch.py`: by its SASS the softmax is about
// 500 instructions a warp a tile, near the other warpgroup's products in
// issue slots).  Later work: that
// overlap at D 256, 80-key tiles, the wgmma form at D 64 and in fp32 (TF32
// wgmma, which at D 256 needs Q's two halves
// and V transposed in three parts in shared memory, over the 227 KB a block
// may have beside K), and a GQA-aware kernel (K/V are repeated before the
// call today).
//
// Every kernel: rows past T load as zeros and are never stored (T is never
// padded).  A K/V tile whose segment ids all lie outside the query tile's
// [min, max] segment range is skipped without being loaded (pad keys for a
// tile of valid queries, and the reverse); the ragged edge, the diagonal tile
// and a tile whose ids are not all the query tile's single id are masked
// element by element, the rest is not.  With `causal` the key loop ends at
// the query tile's last row, and the query tiles are handed out longest
// first, so that the short ones fill the tail.
//
// Training: when the caller passes `lse`, each in-range row also writes its
// log-sum-exp `m + log l` to lse[B, H, T] (one tensor in place of the TPU
// kernel's lane-broadcast `l` and `m`), the residual the backward kernels in
// flash_attention_bwd.cu recompute the probabilities from.  With a null
// pointer the kernel does what it did before.

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"
#include "flash_attention_tf32.cuh"
#include "flash_attention_wgmma.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// The bf16 form on the tensor cores up to D 128.  One block of 4 warps per
// (64-query tile, head, batch row); warp w owns query rows 16 w .. 16 w + 15 whole, so a row's
// running max and sum reduce within its lane quad.  Per 64-key tile:
//   S = Q K^T   (mma.sync, fp32 sums; then s = S * scale, masked)
//   p = exp(s - m)  rounded to bf16 in registers as the A operand of P V,
//                   its row sum taken from the unrounded p
//   O = O * alpha + P V   (V read by ldmatrix.trans)
// K/V tiles are double-buffered: the next visible tile's cp.async overlaps the
// current tile's products.  Q is staged once and held as A fragments.
// ---------------------------------------------------------------------------

namespace fa_mma = flash::mma;

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * fa_mma::ROWS * D * 5;  // Q, K x 2, V x 2
}

template <int D>
__global__ void __launch_bounds__(fa_mma::THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int H,
                     float scale, int causal) {
  using namespace fa_mma;
  static_assert(D <= 64, "D 128 and 256 run flash_fwd_wgmma_kernel");
  constexpr int TILE_ELEMS = ROWS * D;
  constexpr int KC = D / 16;  // k-chunks of q.k^T
  constexpr int NT = D / 8;   // n-tiles of the output columns

  extern __shared__ uint4 smem_fwd[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_fwd);
  bf16* Ks = Qs + TILE_ELEMS;      // [2][ROWS][D]
  bf16* Vs = Ks + 2 * TILE_ELEMS;  // [2][ROWS][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;

  int qlo, qhi;
  segment_range(segb, q0, T, lane, qlo, qhi);
  // causal: the tiles past the diagonal tile (k0 == q0) hold no visible key
  const int k_end = causal ? min(T, q0 + ROWS) : T;

  stage_tile<D>(Qs, q, base, ld, q0, T, tid);
  cp_async_commit();
  bool uniform, uniform_next;
  int k0 = next_tile(segb, 0, k_end, T, qlo, qhi, lane, uniform);
  if (k0 < k_end) {  // always: every in-range query sees its own key
    stage_tile<D>(Ks, k, base, ld, k0, T, tid);
    stage_tile<D>(Vs, v, base, ld, k0, T, tid);
  }
  cp_async_commit();

  // this thread's two rows, r and r + 8 of the warp's 16
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) load_a<D>(qa[kc], Qs, warp * 16, kc, lane);

  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int stage = 0;
  while (k0 < k_end) {
    const int kn = next_tile(segb, k0 + ROWS, k_end, T, qlo, qhi, lane, uniform_next);
    if (kn < k_end) {
      stage_tile<D>(Ks + (stage ^ 1) * TILE_ELEMS, k, base, ld, kn, T, tid);
      stage_tile<D>(Vs + (stage ^ 1) * TILE_ELEMS, v, base, ld, kn, T, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + stage * TILE_ELEMS;
    const bf16* Vt = Vs + stage * TILE_ELEMS;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        load_b<D>(kb, Kt, jp * 16, kc, lane);
        mma_bf16(s[2 * jp], qa[kc], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa[kc], kb[2], kb[3]);
      }
    }

    // The ragged edge, the diagonal tile and a tile whose ids are not all the
    // query tile's single id are masked element by element; the rest is not.
    const bool masked = !uniform || k0 + ROWS > T || (causal && k0 + ROWS > q0);
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = e < 2 ? row0 : row1;
          const bool ok = key < T && segb[key] == (e < 2 ? seg0 : seg1) &&
                          (!causal || key <= row);
          x = ok ? x : neg_inf();
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row that has seen no visible key yet keeps m = -inf; exponents
      // are then taken against 0 so that no -inf - -inf makes a NaN
      const float m_use = (m_new == neg_inf()) ? 0.f : m_new;
      alpha[i] = exp2f((m[i] - m_use) * LOG2E);
      mb[i] = m_use * LOG2E;
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], LOG2E, -mb[e >> 1]));
        l[e >> 1] += p;  // this thread's share of the row sum, unrounded
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // the accumulators of n-tiles 2 kk and 2 kk + 1 are the A fragment of
      // keys 16 kk .. 16 kk + 15, rounded to bf16 for p.v only
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        load_b_trans<D>(vb, Vt, kk * 16, np, lane);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    k0 = kn;
    uniform = uniform_next;
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = i == 0 ? row0 : row1;
    if (t < T) {
      // l > 0: every in-range query sees at least its own key
      const float inv = 1.f / l[i];
      __nv_bfloat16* dst = out + base + (long)t * ld + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      if (lse != nullptr && t4 == 0) lse[((long)b * H + h) * T + t] = m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 form at D 256 on Hopper's own units (flash_attention_wgmma.cuh).
// One launch a call; one block of 3 warpgroups per (128-query tile, head,
// batch row): two consumer warpgroups of 64 query rows each and a producer
// warpgroup, of which one warp issues the copies.
//   producer:  Q once by TMA; the visible K/V tiles of 64 keys by TMA into a
//              two-stage ring, each stage's `full` barrier counting the bytes
//              in and its `empty` barrier the 8 consumer warps out, so the
//              next tile's copy runs under this tile's products.
//   consumers: per K/V tile, S = Q K^T on wgmma m64n64k16 (Q and K from
//              shared memory, 16 k-steps over D); the online softmax in
//              registers as the mma form does it (a row's max and sum within
//              its lane quad); p rounded to bf16 as the register A operand of
//              O += P V on wgmma m64n256k16, V read transposed (MN-major)
//              from shared memory, 4 k-steps over the 64 keys.  o is 128 fp32
//              registers a thread, the whole row, so S and the softmax are
//              formed once (the mma form's two column-half launches formed
//              them twice).
// Every warp walks the same tile sequence (`next_tile` over the 128-row query
// tile's segment range), so the producer and the consumers agree on it
// without passing it through shared memory.  With `causal` a warpgroup skips
// the products of a tile wholly above its own diagonal (still releasing the
// stage), and only its diagonal, ragged and mixed-segment tiles are masked.
// ---------------------------------------------------------------------------

namespace fa_hop = flash::hopper;

constexpr int WG_QROWS = 128;  // query rows of a block: two warpgroups of 64
constexpr int WG_KROWS = 64;   // keys of a K/V tile
constexpr int WG_THREADS = 384;  // 2 consumer warpgroups + 1 producer warpgroup

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // Q, then K and V x 2 stages, then 5 barriers; 1024 bytes to align the
  // tiles to the swizzle's 1024-byte period
  return 2 * (size_t)D * (WG_QROWS + 4 * WG_KROWS) + 5 * 8 + 1024;
}

// Registers: the block starts at 168 a thread (3 warpgroups fill the SM's
// 64K; one block a SM, as the 197 KB of shared memory allows); then
// `setmaxnreg` moves them: the producer warpgroup keeps 40, each consumer
// thread gets 232 (128 x 40 + 256 x 232 = 64,512) for o (128), S (32) and
// its P fragments (16) beside its row state.  At 168 a consumer spilled.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const int* __restrict__ seg,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int H,
                       float scale, int causal) {
  using namespace fa_hop;
  using fa_mma::LOG2E;
  using fa_mma::pack_bf16;
  static_assert(D == 256, "the wgmma form is built for D 256");
  constexpr int CB = D / 64;                              // 128-byte column blocks of a row
  constexpr uint32_t Q_BLOCK = WG_QROWS * 128;            // bytes of a Q column block
  constexpr uint32_t KV_BLOCK = WG_KROWS * 128;           // bytes of a K or V column block
  constexpr uint32_t KV_TILE = CB * KV_BLOCK;             // bytes of a K or V tile
  constexpr uint32_t Q_TILE = CB * Q_BLOCK;

  extern __shared__ uint8_t smem_wg[];
  const uint32_t sQ = (smem_u32(smem_wg) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Q_TILE;           // [2 stages][CB][64 keys][64]
  const uint32_t sV = sK + 2 * KV_TILE;      // [2 stages][CB][64 keys][64]
  const uint32_t q_full = sV + 2 * KV_TILE;  // then full[2], empty[2]
  const uint32_t full0 = q_full + 8, empty0 = q_full + 24;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * WG_QROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int* segb = seg + (long)b * T;

  int qlo, qhi;
  fa_mma::segment_range<WG_QROWS>(segb, q0, T, lane, qlo, qhi);
  // causal: the tiles past the query tile's last row hold no visible key
  const int k_end = causal ? min(T, q0 + WG_QROWS) : T;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  bool uniform, uniform_next;
  int k0 = fa_mma::next_tile(segb, 0, k_end, T, qlo, qhi, lane, uniform);

  if (warp >= 8) {  // ---- the producer warpgroup: one warp copies ----
    setmaxnreg_dec<40>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, Q_TILE);
      for (int c = 0; c < CB; ++c) tma_load_4d(sQ + c * Q_BLOCK, &qmap, q_full, 64 * c, h, q0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    while (k0 < k_end) {  // always entered: every in-range query sees its own key
      if (lane == 0) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the round before freed this stage
        const uint32_t full = full0 + 8 * stage;
        mbar_arrive_expect_tx(full, 2 * KV_TILE);
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(sK + stage * KV_TILE + c * KV_BLOCK, &kmap, full, 64 * c, h, k0, b);
          tma_load_4d(sV + stage * KV_TILE + c * KV_BLOCK, &vmap, full, 64 * c, h, k0, b);
        }
      }
      k0 = fa_mma::next_tile(segb, k0 + WG_KROWS, k_end, T, qlo, qhi, lane, uniform_next);
      if (++stage == 2) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {  // ---- the consumer warpgroups ----
    setmaxnreg_inc<232>();
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    const int wq0 = q0 + 64 * wg;  // this warpgroup's first query row
    // this thread's two rows, r and r + 8 of its warp's 16
    const int row0 = wq0 + 16 * (warp & 3) + g, row1 = row0 + 8;
    const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;

    float m[2] = {flash::neg_inf(), flash::neg_inf()}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    while (k0 < k_end) {
      const int kn =
          fa_mma::next_tile(segb, k0 + WG_KROWS, k_end, T, qlo, qhi, lane, uniform_next);
      mbar_wait(full0 + 8 * stage, phase);
      if (!causal || k0 <= wq0 + 63) {  // else the tile is wholly above this warpgroup's diagonal
        const uint32_t kt = sK + stage * KV_TILE, vt = sV + stage * KV_TILE;
        float s[32];
        fence_operands(s);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          // k-step kc: column block kc / 4, 32 bytes a step within it
          const uint32_t at = (kc & 3) * 32;
          wgmma_m64n64k16_ss(s, desc_sw128(sQ + (kc >> 2) * Q_BLOCK + wg * 64 * 128 + at, 16, 1024),
                             desc_sw128(kt + (kc >> 2) * KV_BLOCK + at, 16, 1024), kc > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);

        // The ragged edge, this warpgroup's diagonal tile and a tile whose ids
        // are not all the query tile's single id are masked element by element.
        const bool masked = !uniform || k0 + WG_KROWS > T || (causal && k0 + WG_KROWS > wq0);
        float mx[2] = {flash::neg_inf(), flash::neg_inf()};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = s[i] * scale;
          if (masked) {
            const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
            const int row = (i & 2) ? row1 : row0;
            const bool ok = key < T && segb[key] == ((i & 2) ? seg1 : seg0) &&
                            (!causal || key <= row);
            x = ok ? x : flash::neg_inf();
          }
          s[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        float alpha[2], mb[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          // a row that has seen no visible key yet keeps m = -inf; exponents
          // are then taken against 0 so that no -inf - -inf makes a NaN
          const float m_use = (m_new == flash::neg_inf()) ? 0.f : m_new;
          alpha[r] = exp2f((m[r] - m_use) * LOG2E);
          mb[r] = m_use * LOG2E;
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float p = exp2f(fmaf(s[i], LOG2E, -mb[(i >> 1) & 1]));
          l[(i >> 1) & 1] += p;  // this thread's share of the row sum, unrounded
          s[i] = p;
        }
        // the accumulators of n-tiles 2 kk and 2 kk + 1 are the A fragment of
        // keys 16 kk .. 16 kk + 15, rounded to bf16 for p.v only
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* c = s + 8 * kk;
          pa[kk][0] = pack_bf16(c[0], c[1]);
          pa[kk][1] = pack_bf16(c[2], c[3]);
          pa[kk][2] = pack_bf16(c[4], c[5]);
          pa[kk][3] = pack_bf16(c[6], c[7]);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        // the rescaled o and the P fragments are written before the fence
        fence_operands(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_operands(pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n256k16_rs_mn(o, pa[kk], desc_sw128(vt + kk * 16 * 128, KV_BLOCK, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // this warp is done with the stage
      k0 = kn;
      uniform = uniform_next;
      if (++stage == 2) {
        stage = 0;
        phase ^= 1;
      }
    }

    // element i of o: row (i & 2) ? row1 : row0, column 8 (i / 4) + 2 t4 + (i & 1)
    const long ld = (long)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int t = r == 0 ? row0 : row1;
      if (t < T) {
        // l > 0: every in-range query sees at least its own key
        const float inv = 1.f / l[r];
        __nv_bfloat16* dst = out + (long)b * T * ld + (long)t * ld + (long)h * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        if (lse != nullptr && t4 == 0) lse[((long)b * H + h) * T + t] = m[r] + logf(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 form at D 128 on Hopper's own units: the D 256 kernel's block (a
// producer warp, two consumer warpgroups of 64 query rows, Q copied once by
// TMA, K/V tiles streamed by TMA into an mbarrier ring), laid out for D 128.
// A thread's share of o is 64 fp32 registers (m64n128k16 for O += P V),
// which leaves room for a score tile of 128 keys in flight (64 registers,
// m64n128k16 from shared memory: a third fewer operand bytes per product
// than 64-key tiles) beside the bf16 P fragments of the tile before (32),
// under `setmaxnreg` 24 / 240.  Per warpgroup, in FA3's intra-warpgroup
// order:
//   first tile:  S_0 = Q K_0^T; its softmax
//   tile j > 0:  wait for P_{j-2} V_{j-2} and release its stage; o *=
//                alpha_{j-1}; P_{j-1} rounded to bf16 into registers; issue
//                S_j = Q K_j^T, then O += P_{j-1} V_{j-1}, two commit groups;
//                wait for S_j alone; the softmax of S_j (scale, mask, max,
//                exp, row sum) runs on the FMA and SFU pipes while
//                P_{j-1} V_{j-1} runs on the tensor cores
//   after the walk: o *= alpha; O += P_last V_last
// No product is issued under a branch, so ptxas keeps every wgmma
// asynchronous (`kernel_build` checks its log for the warnings that say
// otherwise).  The wait for a tile's P V sits at the top of the next round,
// after the copy waits: ptxas schedules a wait at the top of its basic
// block, and a wait at the end of the round ran before that round's
// exponents (read from the SASS).  The two warpgroups take turns issuing
// their products (FA3's ping-pong, named barriers 1 and 2), so that one's
// softmax also runs under the other's products; for their turns to pair up
// both walk the block's tiles, and the 128-query block's diagonal tile is
// the last of both, masked element by element.  K and V of a stage have
// barriers of their own, so S_j starts when K_j has landed; three stages
// (Q 32 KB, 64 KB a stage: 230,480 B, one block a SM) keep the next tile's
// copy in flight while a stage is still read.  The sums per output element
// run one tile at a time: o rescaled, then the tile's 16-key k-steps in
// turn.  Measured against 64-key tiles, two stages, no turns, Q in
// registers and the scale folded into the exponent: PERF.md §6.
// ---------------------------------------------------------------------------

constexpr int FWD128_KEYS = 128;  // keys of a K/V tile at D 128
constexpr int FWD128_STAGES = 3;  // stages of the K/V ring at D 128

constexpr size_t wgmma128_smem_bytes() {
  // Q (128 rows), then K and V x FWD128_STAGES, then the Q barrier and a K
  // `full`, V `full` and `empty` barrier a stage; 1024 bytes to align the
  // tiles to the swizzle's 1024-byte period
  return 2 * 128 * (WG_QROWS + 2 * FWD128_STAGES * FWD128_KEYS) + (1 + 3 * FWD128_STAGES) * 8 +
         1024;
}
static_assert(wgmma128_smem_bytes() <= 232448, "more shared memory than a block may have");

// 2^x on the SFU alone: exp2f's guard for a subnormal result costs three
// instructions an element, and such a p (below 2^-126) is flushed to 0 here,
// far under any rounding of o or of its row sum (the row's largest p is 1)
__device__ __forceinline__ float fwd_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64 x 128 score tile in place, as the D 256
// kernel forms it: s (this thread's 64 elements of a wgmma m64n128
// accumulator, rows row0 and row1) becomes p = exp(s * scale - m), masked
// elements 0; the rows' running max m and unrounded sum l are updated, and
// alpha is what o is to be rescaled by.  `masked`: the ragged edge, the
// diagonal tile and a tile whose ids are not all the query tile's single id
// are masked element by element, without a branch an element (the segment
// ids are read only where `uniform` is false); the rest are only scaled.
__device__ __forceinline__ void fwd_online_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                                   float (&alpha)[2], bool masked, bool uniform,
                                                   int k0, const int* __restrict__ segb, int T,
                                                   int seg0, int seg1, int row0, int row1,
                                                   int t4, int causal, float scale) {
  using fa_mma::LOG2E;
  float mx[2] = {flash::neg_inf(), flash::neg_inf()};
  if (!masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] *= scale;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int row = (i & 2) ? row1 : row0;
      // a uniform tile's in-range ids are all the rows' own
      const bool same =
          uniform | (__ldg(segb + min(key, T - 1)) == ((i & 2) ? seg1 : seg0));
      const bool ok = (key < T) & same & (!causal | (key <= row));
      const float x = ok ? s[i] * scale : flash::neg_inf();
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row that has seen no visible key yet keeps m = -inf; exponents are
    // then taken against 0 so that no -inf - -inf makes a NaN
    const float m_use = (m_new == flash::neg_inf()) ? 0.f : m_new;
    alpha[r] = fwd_exp2((m[r] - m_use) * LOG2E);
    mb[r] = m_use * LOG2E;
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = fwd_exp2(fmaf(s[i], LOG2E, -mb[(i >> 1) & 1]));
    l[(i >> 1) & 1] += p;  // this thread's share of the row sum, unrounded
    s[i] = p;
  }
}

template <>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel<128>(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, const int* __restrict__ seg,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int H,
                            float scale, int causal) {
  using namespace fa_hop;
  constexpr int D = 128;
  constexpr int KT = FWD128_KEYS;
  constexpr int STAGES = FWD128_STAGES;
  constexpr uint32_t Q_BLOCK = WG_QROWS * 128;  // bytes of a Q column block (64 columns)
  constexpr uint32_t KV_BLOCK = KT * 128;       // bytes of a K or V column block
  constexpr uint32_t Q_TILE = (D / 64) * Q_BLOCK;
  constexpr uint32_t KV_TILE = (D / 64) * KV_BLOCK;

  extern __shared__ uint8_t smem_wg128[];
  const uint32_t sQ = (smem_u32(smem_wg128) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Q_TILE;                // [STAGES][D / 64][KT keys][64]
  const uint32_t sV = sK + STAGES * KV_TILE;      // [STAGES][D / 64][KT keys][64]
  const uint32_t q_full = sV + STAGES * KV_TILE;  // then k_full, v_full, empty [STAGES]
  const uint32_t k_full0 = q_full + 8, v_full0 = k_full0 + 8 * STAGES,
                 empty0 = v_full0 + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * WG_QROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int* segb = seg + (long)b * T;

  int qlo, qhi;
  fa_mma::segment_range<WG_QROWS>(segb, q0, T, lane, qlo, qhi);
  // causal: the tiles past the query tile's last row hold no visible key
  const int k_end = causal ? min(T, q0 + WG_QROWS) : T;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full0 + 8 * st, 1);
      mbar_init(v_full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  bool uniform, uniform_next;
  if (warp >= 8) {  // ---- the producer warpgroup: one warp copies ----
    setmaxnreg_dec<24>();
    if (warp > 8) return;
    int k0 = fa_mma::next_tile<KT>(segb, 0, k_end, T, qlo, qhi, lane, uniform);
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, Q_TILE);
      for (int c = 0; c < D / 64; ++c) tma_load_4d(sQ + c * Q_BLOCK, &qmap, q_full, 64 * c, h, q0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    while (k0 < k_end) {  // always entered: every in-range query sees its own key
      if (lane == 0) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the round before freed this stage
        const uint32_t kf = k_full0 + 8 * stage, vf = v_full0 + 8 * stage;
        mbar_arrive_expect_tx(kf, KV_TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sK + stage * KV_TILE + c * KV_BLOCK, &kmap, kf, 64 * c, h, k0, b);
        mbar_arrive_expect_tx(vf, KV_TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sV + stage * KV_TILE + c * KV_BLOCK, &vmap, vf, 64 * c, h, k0, b);
      }
      k0 = fa_mma::next_tile<KT>(segb, k0 + KT, k_end, T, qlo, qhi, lane, uniform);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {  // ---- the consumer warpgroups ----
    setmaxnreg_inc<240>();
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    const int wq0 = q0 + 64 * wg;  // this warpgroup's first query row
    // this thread's two rows, r and r + 8 of its warp's 16
    const int row0 = wq0 + 16 * (warp & 3) + g, row1 = row0 + 8;
    const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;
    const uint32_t qa = sQ + wg * 64 * 128;  // this warpgroup's rows of each Q column block

    // S = Q K^T over D for this warpgroup's 64 rows: 8 k-steps of m64n128k16
    // from shared memory (k-step kc: column block kc / 4, 32 bytes a step
    // within it), one commit group
    const auto issue_scores = [&](float (&s)[64], uint32_t kt) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t at = (kc & 3) * 32;
        wgmma_m64n128k16_ss(s, desc_sw128(qa + (kc >> 2) * Q_BLOCK + at, 16, 1024),
                            desc_sw128(kt + (kc >> 2) * KV_BLOCK + at, 16, 1024), kc > 0);
      }
      wgmma_commit();
    };
    // O += P V: 8 k-steps of m64n128k16 over the tile's keys, p in registers,
    // V read transposed (MN-major), one commit group
    const auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[8][4], uint32_t vt) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128k16_rs_mn(o, pa[kk], desc_sw128(vt + kk * 16 * 128, KV_BLOCK, 1024));
      wgmma_commit();
    };
    const auto masked_tile = [&](int k0, bool uni) {
      return !uni || k0 + KT > T || (causal && k0 + KT > wq0);
    };
    // the turns: warpgroup w waits on barrier 1 + w before it issues its
    // products, then lets the other one go; warpgroup 0 goes first
    const auto my_turn = [&] { flash::tf32::group_sync(1 + wg, 256); };
    const auto their_turn = [&] { flash::tf32::group_arrive(2 - wg, 256); };
    if (wg == 0) flash::tf32::group_arrive(1, 256);

    float m[2] = {flash::neg_inf(), flash::neg_inf()}, l[2] = {0.f, 0.f}, alpha[2];
    // element i of o: row (i & 2) ? row1 : row0, column 8 (i / 4) + 2 t4 + (i & 1)
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[64];
    uint32_t pa[8][4];
    // the first tile: its scores alone
    int k0 = fa_mma::next_tile<KT>(segb, 0, k_end, T, qlo, qhi, lane, uniform);
    mbar_wait(q_full, 0);
    mbar_wait(k_full0, 0);
    fence_operands(s);
    my_turn();
    wgmma_fence();
    issue_scores(s, sK);
    their_turn();
    int kn = fa_mma::next_tile<KT>(segb, k0 + KT, k_end, T, qlo, qhi, lane, uniform_next);
    wgmma_wait<0>();
    fence_operands(s);
    fwd_online_softmax(s, m, l, alpha, masked_tile(k0, uniform), uniform, k0, segb, T, seg0,
                       seg1, row0, row1, t4, causal, scale);
    // stages: `cur` holds the tile whose p is in s, `held` the one whose P V
    // is in flight (-1: none), `stage` the next tile's
    int cur = 0, held = -1, stage = 1;
    uint32_t cur_phase = 0, phase = 0;
    k0 = kn;
    uniform = uniform_next;

    // Each tile's P V is waited for at the top of the next round, after the
    // copy waits: ptxas places a wait at the top of its basic block, and a
    // wait at the end of the round would run before that round's exponents.
    while (k0 < k_end) {
      mbar_wait(k_full0 + 8 * stage, phase);
      mbar_wait(v_full0 + 8 * cur, cur_phase);
      wgmma_wait<0>();  // the P V before
      fence_operands(o);
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * held);  // this warp is done with that stage
      }
      // o = o * alpha + P V, the tile's P rounded to bf16 as the A operand
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      score_as_a(s, pa);
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_operands(pa[kk]);
      fence_operands(s);
      my_turn();
      wgmma_fence();
      issue_scores(s, sK + stage * KV_TILE);
      issue_pv(o, pa, sV + cur * KV_TILE);
      their_turn();
      // the walk's next tile, voted on while the products run
      kn = fa_mma::next_tile<KT>(segb, k0 + KT, k_end, T, qlo, qhi, lane, uniform_next);
      wgmma_wait<1>();  // S of this tile; the tile before's P V still runs
      fence_operands(s);
      fwd_online_softmax(s, m, l, alpha, masked_tile(k0, uniform), uniform, k0, segb, T, seg0,
                         seg1, row0, row1, t4, causal, scale);
      held = cur;
      cur = stage;
      cur_phase = phase;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      k0 = kn;
      uniform = uniform_next;
    }

    // the last tile's P V
    mbar_wait(v_full0 + 8 * cur, cur_phase);
    wgmma_wait<0>();
    fence_operands(o);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    score_as_a(s, pa);
    fence_operands(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_operands(pa[kk]);
    wgmma_fence();
    issue_pv(o, pa, sV + cur * KV_TILE);
    wgmma_wait<0>();
    fence_operands(o);

    const long ld = (long)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int t = r == 0 ? row0 : row1;
      if (t < T) {
        // l > 0: every in-range query sees at least its own key
        const float inv = 1.f / l[r];
        __nv_bfloat16* dst = out + (long)b * T * ld + (long)t * ld + (long)h * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        if (lse != nullptr && t4 == 0)
          lse[((long)b * H + h) * T + t] = m[r] + logf(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 form on the tensor cores at D 32 and 64, 3xTF32 (see the notes at
// the top).  The bf16 kernel's block layout and loop; Q is held split in
// shared memory, and each 32-key K/V tile is staged in one stage and split in
// place.
// ---------------------------------------------------------------------------

constexpr int TF32_KEYS = 32;  // keys of a staged K/V tile of the fp32 kernels

template <int D>
constexpr size_t tf32_smem_bytes() {
  // Q as big and small halves (64 rows); K as big and small halves, V as big
  // half and rest (32 rows each): 69,632 bytes at D 64
  return sizeof(float) * (D + 4) * (2 * fa_mma::ROWS + 4 * TF32_KEYS);
}

template <int D>
__global__ void __launch_bounds__(fa_mma::THREADS)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ seg,
                      float* __restrict__ out, float* __restrict__ lse, int T, int H,
                      float scale, int causal) {
  using namespace fa_mma;
  using namespace flash::tf32;
  static_assert(D <= 64, "D 128 and 256 run flash_fwd_tf32_split_kernel");
  constexpr int BK = TF32_KEYS;       // keys of a staged K/V tile
  constexpr int QW = ROWS * (D + 4);  // words of the staged Q tile
  constexpr int KW = BK * (D + 4);    // words of a staged K or V tile
  constexpr int KC = D / 8;           // k-chunks of q.k^T; n-tiles of the output
  constexpr int NC = BK / 8;          // 8-key n-tiles of a K/V tile

  extern __shared__ float4 smem_fwd_tf32[];
  float* Qbig = reinterpret_cast<float*>(smem_fwd_tf32);
  float* Qsmall = Qbig + QW;
  float* Kbig = Qsmall + QW;
  float* Ksmall = Kbig + KW;
  float* Vbig = Ksmall + KW;
  float* Vrest = Vbig + KW;  // v - big, unrounded

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;

  int qlo, qhi;
  segment_range(segb, q0, T, lane, qlo, qhi);
  // causal: the keys past the query tile's last row are visible to none of it
  const int k_end = causal ? min(T, q0 + ROWS) : T;

  stage_tile_f32<D>(Qbig, q, base, ld, q0, T, tid);
  cp_async_commit();
  bool uniform, uniform_next;
  int k0 = next_tile<BK>(segb, 0, k_end, T, qlo, qhi, lane, uniform);

  // this thread's two rows, r and r + 8 of the warp's 16
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;

  cp_async_wait<0>();
  __syncthreads();
  split_tile_f32<D>(Qbig, Qsmall, tid);  // read after the loop's first barrier

  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float o[KC][4];
#pragma unroll
  for (int j = 0; j < KC; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  while (k0 < k_end) {  // always entered: every in-range query sees its own key
    stage_tile_f32<D, BK>(Kbig, k, base, ld, k0, T, tid);
    stage_tile_f32<D, BK>(Vbig, v, base, ld, k0, T, tid);
    cp_async_commit();
    const int kn = next_tile<BK>(segb, k0 + BK, k_end, T, qlo, qhi, lane, uniform_next);
    cp_async_wait<0>();
    __syncthreads();
    split_tile_f32<D, false, BK>(Kbig, Ksmall, tid);
    split_tile_f32<D, true, BK>(Vbig, Vrest, tid);
    __syncthreads();

    // element (n, e) of s: row e < 2 ? g : g + 8, key k0 + 8 n + 2 t4 + (e & 1)
    float s[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qb[4], qs[4];
      load_a_f32<D>(qb, Qbig, warp * 16, kc, lane);
      load_a_f32<D>(qs, Qsmall, warp * 16, kc, lane);
#pragma unroll
      for (int n = 0; n < NC; n += 2) {
        uint32_t kb[4], ks[4];
        load_b2<D>(kb, Kbig, 8 * n, kc, lane);
        load_b2<D>(ks, Ksmall, 8 * n, kc, lane);
        mma_3xtf32(s[n], qb, qs, kb[0], kb[1], ks[0], ks[1]);
        mma_3xtf32(s[n + 1], qb, qs, kb[2], kb[3], ks[2], ks[3]);
      }
    }

    // the ragged edge, the diagonal tiles and a tile whose ids are not all
    // the query tile's single id are masked element by element
    const bool masked = !uniform || k0 + BK > T || (causal && k0 + BK > q0);
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (masked) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          const int row = e < 2 ? row0 : row1;
          const bool ok = key < T && segb[key] == (e < 2 ? seg0 : seg1) &&
                          (!causal || key <= row);
          x = ok ? x : neg_inf();
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row that has seen no visible key yet keeps m = -inf; exponents
      // are then taken against 0 so that no -inf - -inf makes a NaN
      m_use[i] = (m_new == neg_inf()) ? 0.f : m_new;
      alpha[i] = exp2f((m[i] - m_use[i]) * LOG2E);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // (s - m) first: the row's largest element gets exactly 1
        const float p = exp2f((s[n][e] - m_use[e >> 1]) * LOG2E);
        l[e >> 1] += p;  // this thread's share of the row sum, of the p that enters P V
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // n-tile n of p is the A operand of the k-chunk over its 8 keys; each
    // output n-tile j takes the tile's k-chunks in turn
    uint32_t pb[NC][4], ps[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n) acc_as_a(s[n], pb[n], ps[n]);
#pragma unroll
    for (int j = 0; j < KC; ++j) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        uint32_t vb[2], vr[2];
        load_bt<D>(vb, Vbig, 8 * n, j, g, t4);
        load_bt<D>(vr, Vrest, 8 * n, j, g, t4);
        mma_4xtf32(o[j], pb[n], ps[n], vb[0], vb[1], vr[0], vr[1]);
      }
    }
    __syncthreads();  // every warp is done with this tile before the next is staged
    k0 = kn;
    uniform = uniform_next;
  }

  // element (j, e) of o: row e < 2 ? g : g + 8, head-dim column 8 j + 2 t4 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = i == 0 ? row0 : row1;
    if (t < T) {
      // l > 0: every in-range query sees at least its own key
      const float inv = 1.f / l[i];
      float* dst = out + base + (long)t * ld + 2 * t4;
#pragma unroll
      for (int j = 0; j < KC; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      if (lse != nullptr && t4 == 0) lse[((long)b * H + h) * T + t] = m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 form at D 128 and 256: the layout of the backward's dQ split kernel
// (flash_attention_bwd.cu), with the online softmax in place of dS.  One
// block of 8 warps per (64-query tile, head, batch row); warp w takes query
// group qg = w / 2 (rows 16 qg .. 16 qg + 15) and o's columns D/2 hf ..
// D/2 hf + D/2 - 1, hf = w % 2 (D/8 accumulators a thread).  Per K/V tile
// (up to the diagonal with `causal`):
//   S's half hf = Q[:, hf] K[:, hf]^T     (3xTF32, D/16 k-chunks of 8)
//   exchange with the partner warp; S = half 0 + half 1 in fp32, so both
//   warps of the group hold the same S, m, l and p to the bit
//   s = S * scale masked; m, alpha, p = 2^((s - m) log2 e), l   (as up to D 64)
//   O[:, hf] = O[:, hf] * alpha + P V[:, hf]   (V split exactly, mma_4xtf32)
// K and V are staged raw by cp.async, and each of their operand words is
// split into its TF32 parts as its fragment is loaded, so the next tile's
// copy runs under this tile's products; Q stays resident, raw (split as
// loaded) or split once into big and small halves (`SplitFwd`).  With
// `causal` a query group skips the products of a tile wholly above its rows
// (alpha would be 1 and p 0).  With `LAG` the groups of rows 32 .. 63 add a
// tile's P V at the start of the next tile instead of at the end of its own
// (the same sums in the same order), so that warp w, leading, forms S or
// P V while warp w + 4, on the same scheduler, runs its softmax, and the
// reverse; the tile before last stays resident, so the ring has three
// stages.
//
// Replaces, at both head sizes, the upstream Pallas `flash_attention`
// forward (`_flash_attention_kernel`) that roar_tpu/models/gpt.py:491-535
// and roar_tpu/models/transformer.py:72-114 reach.  Bound: 4 B H pairs D
// operations in three TF32 products each, 0.834 ms at (1, 4096, 32, 128)
// causal on the H100's 494.7 TFLOP/s (operations).
//
// At D 256 (16-key tiles, Q raw), measured against this form at (1, 2048, 8,
// 256) causal (NVIDIA H100 80GB HBM3, 700.00 W): 32-key tiles (216,064 B)
// spilled at 255 registers and ran no faster; 16 warps over column quarters
// (128 registers a thread) ran about 5 % slower; K and V split once a tile
// in shared memory, behind a second barrier, about 15 % slower.  At D 128
// (32-key tiles, Q in halves, three stages, LAG), in turns at (1, 4096, 32,
// 128) causal (NVIDIA H100 80GB HBM3, 700.00 W,
// `scripts/flash_kernel_times_torch.py --dtype float32` on checkouts of
// each form; the card's pace moved between calls, so each form stands
// beside the two-stage form with Q in halves and no LAG of the same call):
//   this form 4.22 / 4.19, 4.46 / 4.50, 4.30 / 4.26 ms against 4.35 / 4.31,
//     4.53 / 4.61, 4.58 / 4.64; three stages without LAG 4.42 / 4.49
//     against 4.35 / 4.31;
//   Q split as loaded (the D 256 way): 4.42 / 4.47 against 4.27 / 4.15;
//   16-key tiles, 128 registers, two blocks a SM (109,568 B): 4.20 / 4.23,
//     4.21 / 4.20, 4.28 / 4.21 against 4.27 / 4.15, 4.30 / 4.30, 4.35 /
//     4.31; the same with Q split as loaded spilled: 4.56 / 4.64;
//   64-key tiles (Q split as loaded) spilled at 255 registers: 4.82 / 4.98
//     against 4.27 / 4.15;
//   the S loop unrolled 4 times, not 8: 4.49 / 4.44 against 4.27 / 4.15,
//     and with LAG 4.21 / 4.36 against this form's 4.30 / 4.26;
//   K, or K and V, split once a tile in shared memory behind a second
//     barrier: 4.57 / 4.57, 4.85 / 4.82 against 4.30 / 4.30; split instead
//     by each thread as its own copies land, with no second barrier: 4.78 /
//     4.70, 4.62 / 4.71 against 4.53 / 4.61 (fewer instructions, more time);
// the 4-warp form before it 7.72 to 7.98.
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 256;  // 8 warps

// the split form's key tile, Q's layout and unroll by head size
template <int D>
struct SplitFwd;
template <>
struct SplitFwd<128> {
  static constexpr int KEYS = 32;         // keys of a staged K/V tile
  static constexpr bool Q_HALVES = true;  // Q split once into big and small halves
  static constexpr int UNROLL = 8;        // of the loop over S's k-chunks
  static constexpr bool LAG = true;       // groups 2 and 3 add P V a phase later
  static constexpr int STAGES = LAG ? 3 : 2;  // of the K/V ring
};
template <>
struct SplitFwd<256> {
  static constexpr int KEYS = 16;
  static constexpr bool Q_HALVES = false;
  static constexpr int UNROLL = 4;
  static constexpr bool LAG = false;
  static constexpr int STAGES = 2;
};

template <int D>
constexpr size_t tf32_split_smem_bytes() {
  using C = SplitFwd<D>;
  // Q (64 rows; or its two halves); K and V x STAGES; each warp's half of
  // its S tile, KEYS / 2 values a lane: 141,312 bytes at D 256, 185,344 at
  // D 128
  return sizeof(float) *
         (((C::Q_HALVES ? 2 : 1) * fa_mma::ROWS + 2 * C::STAGES * C::KEYS) * (D + 4) +
          8 * (C::KEYS / 2) * 32);
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
flash_fwd_tf32_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ seg,
                            float* __restrict__ out, float* __restrict__ lse, int T, int H,
                            float scale, int causal) {
  using namespace fa_mma;
  using namespace flash::tf32;
  using C = SplitFwd<D>;
  constexpr int BK = C::KEYS;         // keys of a staged K/V tile
  constexpr int QW = ROWS * (D + 4);  // words of the Q tile
  constexpr int KW = BK * (D + 4);    // words of a K or V tile
  constexpr int KC = D / 16;          // k-chunks of S's half
  constexpr int NC = BK / 8;          // 8-key n-tiles of a K/V tile
  constexpr int NT = D / 16;          // n-tiles of a warp's half of o's columns
  constexpr int UNROLL = C::UNROLL;
  static_assert(!C::LAG || C::STAGES >= 3, "a lagged P V reads the tile before last");

  extern __shared__ float4 smem_fwd_split[];
  float* Qs = reinterpret_cast<float*>(smem_fwd_split);  // Q, or its big half
  float* Qsmall = Qs + QW;                               // Q's small half (Q_HALVES)
  float* Ks = Qs + (C::Q_HALVES ? 2 : 1) * QW;           // [STAGES][BK][D + 4]
  float* Vs = Ks + C::STAGES * KW;                       // [STAGES][BK][D + 4]
  float* Xs = Vs + C::STAGES * KW;                       // [8 warps][4 NC values][32 lanes]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qg = warp >> 1, hf = warp & 1;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;

  int qlo, qhi;
  segment_range(segb, q0, T, lane, qlo, qhi);
  // causal: the keys past the query tile's last row are visible to none of it
  const int k_end = causal ? min(T, q0 + ROWS) : T;

  stage_tile_f32<D, ROWS, SPLIT_THREADS>(Qs, q, base, ld, q0, T, tid);
  if constexpr (C::Q_HALVES) cp_async_commit();  // Q in a group of its own
  bool uniform, uniform_next;
  int k0 = next_tile<BK>(segb, 0, k_end, T, qlo, qhi, lane, uniform);
  if (k0 < k_end) {  // always: every in-range query sees its own key
    stage_tile_f32<D, BK, SPLIT_THREADS>(Ks, k, base, ld, k0, T, tid);
    stage_tile_f32<D, BK, SPLIT_THREADS>(Vs, v, base, ld, k0, T, tid);
  }
  cp_async_commit();

  // this thread's two rows, g and g + 8 of its group's 16
  const int row0 = q0 + 16 * qg + g, row1 = row0 + 8;
  const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;
  if constexpr (C::Q_HALVES) {
    // Q has landed: each thread splits the words it copied itself (no
    // barrier waits for that), and the loop's first barrier shows them
    cp_async_wait<1>();
    split_tile_f32<D, false, ROWS, SPLIT_THREADS>(Qs, Qsmall, tid);
  }
  float* mine = Xs + warp * 4 * NC * 32 + lane;
  const float* theirs = Xs + (warp ^ 1) * 4 * NC * 32 + lane;

  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // o = o + P V[:, hf] for the p in s (after its o * alpha), n-tile n of p
  // the A operand of the k-chunk over its 8 keys; each of this warp's output
  // n-tiles takes the chunks in key order
  float s[NC][4];
  auto add_pv = [&](int st) {
    const float* v_half = Vs + st * KW + (D / 2) * hf;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      uint32_t pb[4], ps[4];
      acc_as_a(s[n], pb, ps);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t vb[2], vr[2];
        load_bt_rest<D>(vb, vr, v_half, 8 * n, j, g, t4);
        mma_4xtf32(o[j], pb, ps, vb[0], vb[1], vr[0], vr[1]);
      }
    }
  };
  // with LAG, groups 2 and 3 add a tile's P V at the start of the next
  // iteration, so that each scheduler's two warps (w and w + 4) are in
  // different phases: one's softmax runs beside the other's products
  const bool lag = C::LAG && qg >= 2;
  int pending = -1;  // the stage of a lagged P V

  int stage = 0;
  while (k0 < k_end) {
    const int kn = next_tile<BK>(segb, k0 + BK, k_end, T, qlo, qhi, lane, uniform_next);
    // this tile (and Q) has landed, and every warp is done with the stage
    // the next copy fills and with its partner's half of the last S
    cp_async_wait<0>();
    __syncthreads();
    const int next = stage + 1 == C::STAGES ? 0 : stage + 1;
    if (kn < k_end) {
      stage_tile_f32<D, BK, SPLIT_THREADS>(Ks + next * KW, k, base, ld, kn, T, tid);
      stage_tile_f32<D, BK, SPLIT_THREADS>(Vs + next * KW, v, base, ld, kn, T, tid);
    }
    cp_async_commit();
    const float* Kt = Ks + stage * KW;
    if (lag && pending >= 0) {
      add_pv(pending);
      pending = -1;
    }

    if (!causal || k0 <= q0 + 16 * qg + 15) {  // else the tile is above the group's rows
      // this warp's half of S: element (n, e) at row e < 2 ? g : g + 8, key
      // k0 + 8 n + 2 t4 + (e & 1)
#pragma unroll
      for (int n = 0; n < NC; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll(UNROLL)
      for (int kc = 0; kc < KC; ++kc) {
        const int chunk = KC * hf + kc;  // 8-column chunk of the row
        uint32_t qb[4], qs[4];
        if constexpr (C::Q_HALVES) {
          load_a_f32<D>(qb, Qs, 16 * qg, chunk, lane);
          load_a_f32<D>(qs, Qsmall, 16 * qg, chunk, lane);
        } else {
          load_a_split<D>(qb, qs, Qs, 16 * qg, chunk, lane);
        }
#pragma unroll
        for (int n = 0; n < NC; n += 2) {
          uint32_t kb[4], ks[4];
          load_b2_split<D>(kb, ks, Kt, 8 * n, chunk, lane);
          mma_3xtf32(s[n], qb, qs, kb[0], kb[1], ks[0], ks[1]);
          mma_3xtf32(s[n + 1], qb, qs, kb[2], kb[3], ks[2], ks[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = s[n][e];
      group_sync(1 + qg, 64);

      // the whole tile, half 0 + half 1 (the same sum in either warp); the
      // ragged edge, the group's diagonal tiles and a tile whose ids are not
      // all the query tile's single id are masked element by element
      const bool masked = !uniform || k0 + BK > T || (causal && k0 + BK > q0 + 16 * qg);
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = (s[n][e] + theirs[(4 * n + e) * 32]) * scale;
          if (masked) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            const bool ok = key < T && segb[key] == (e < 2 ? seg0 : seg1) &&
                            (!causal || key <= row);
            x = ok ? x : neg_inf();
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // a row that has seen no visible key yet keeps m = -inf; exponents
        // are then taken against 0 so that no -inf - -inf makes a NaN
        m_use[i] = (m_new == neg_inf()) ? 0.f : m_new;
        alpha[i] = exp2f((m[i] - m_use[i]) * LOG2E);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // (s - m) first: the row's largest element gets exactly 1
          const float p = exp2f((s[n][e] - m_use[e >> 1]) * LOG2E);
          l[e >> 1] += p;  // this thread's share of the row sum, of the p that enters P V
          s[n][e] = p;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      if (lag)
        pending = stage;
      else
        add_pv(stage);
    }
    k0 = kn;
    uniform = uniform_next;
    stage = next;
  }
  if (pending >= 0) add_pv(pending);

  // element (j, e) of o: row e < 2 ? g : g + 8, head-dim column
  // D/2 hf + 8 j + 2 t4 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = i == 0 ? row0 : row1;
    if (t < T) {
      // l > 0: every in-range query sees at least its own key
      const float inv = 1.f / l[i];
      float* dst = out + base + (long)t * ld + (D / 2) * hf + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      if (lse != nullptr && hf == 0 && t4 == 0)
        lse[((long)b * H + h) * T + t] = m[i] + logf(l[i]);
    }
  }
}

// One launch a call.  fp32 (`Elem` float): up to D 64 the 4-warp 3xTF32
// kernel, one block of fa_mma::THREADS per (64-query tile, head, batch row),
// at D 128 and 256 the split kernel, one block of SPLIT_THREADS.  bf16: the
// mma.sync kernel up to D 64, the same blocks; at D 128 and 256 the wgmma
// kernel, one block of WG_THREADS per (128-query tile, head, batch row), its
// TMA maps built here.
template <int D, typename Elem>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* out,
                   float* lse, int B, int T, int H, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((T + fa_mma::ROWS - 1) / fa_mma::ROWS, H, B);
  if constexpr (sizeof(Elem) == 2 && D >= 128) {
    CUtensorMap maps[3];
    const void* xs[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      const cudaError_t err = fa_hop::bf16_rows_map(
          &maps[i], xs[i], B, T, H, D, i == 0 ? WG_QROWS : D == 128 ? FWD128_KEYS : WG_KROWS);
      if (err != cudaSuccess) return err;
    }
    constexpr size_t smem = D == 128 ? wgmma128_smem_bytes() : wgmma_smem_bytes<D>();
    const auto kernel = flash_fwd_wgmma_kernel<D>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 wg_grid((T + WG_QROWS - 1) / WG_QROWS, H, B);
    kernel<<<wg_grid, WG_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], seg,
                                                  static_cast<Elem*>(out), lse, T, H, scale,
                                                  causal);
    return cudaGetLastError();
  } else if constexpr (sizeof(Elem) == 2) {
    constexpr size_t smem = mma_smem_bytes<D>();
    const auto kernel = flash_fwd_mma_kernel<D>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, fa_mma::THREADS, smem, stream>>>(
        static_cast<const Elem*>(q), static_cast<const Elem*>(k), static_cast<const Elem*>(v),
        seg, static_cast<Elem*>(out), lse, T, H, scale, causal);
    return cudaGetLastError();
  } else {
    constexpr bool split = D >= 128;
    constexpr size_t smem = [] {
      if constexpr (split) return tf32_split_smem_bytes<D>();
      else return tf32_smem_bytes<D>();
    }();
    const auto kernel = [] {
      if constexpr (split) return flash_fwd_tf32_split_kernel<D>;
      else return flash_fwd_tf32_kernel<D>;
    }();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, split ? SPLIT_THREADS : fa_mma::THREADS, smem, stream>>>(
        static_cast<const Elem*>(q), static_cast<const Elem*>(k), static_cast<const Elem*>(v),
        seg, static_cast<Elem*>(out), lse, T, H, scale, causal);
    return cudaGetLastError();
  }
}

template <typename Elem>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* seg,
                     void* out, float* lse, int B, int T, int H, float scale, int causal,
                     cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, Elem>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    case 64: return launch<64, Elem>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    case 128: return launch<128, Elem>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    case 256: return launch<256, Elem>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, T, H, D] of `bf16 ? bf16 : fp32`; lse: fp32 [B, H, T] or null
extern "C" int roar_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        const int* seg, void* out, float* lse, int B, int T,
                                        int H, int D, float scale, int causal, int bf16,
                                        void* stream) {
  if (flash::bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)launch_d<__nv_bfloat16>(D, q, k, v, seg, out, lse, B, T, H, scale,
                                                causal, s);
  return (int)launch_d<float>(D, q, k, v, seg, out, lse, B, T, H, scale, causal, s);
}

extern "C" const char* roar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
