// Segment-masked flash-attention backward, non-causal and causal, fp32 and
// bf16, for Hopper (sm_90a), on the tensor cores.
//
// Replaces: the two upstream Pallas TPU kernels `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq` of `jax.experimental.pallas.ops.tpu.flash_attention`
// that the custom VJP of `flash_attention` launches with SegmentIds, reached
// in training from roar_tpu/models/transformer.py:110 (`causal=False`) and
// from roar_tpu/models/gpt.py:526/531 and roar_tpu/ops/flash_remat.py:52
// (`causal=True`).
//
// Layout: q, k, v, dout, dq, dk, dv are contiguous [B, T, H, D], fp32 or bf16
// (see flash_attention_common.cuh for the roundings of the bf16 form); seg is
// [B, T] int32; lse (the forward's `m + log l`) and delta (`sum(o * dout, -1)`)
// are [B, H, T] fp32.  Both kernels recompute, per 64 x 64 tile,
//   p  = exp(q.k * scale - lse)   where the two segment ids agree (and, with
//                                 `causal`, key <= query), else 0
//   dP = dout . v^T
//   dS = p * (dP - delta) * scale
// and then
//   dkv kernels: one block per 64-key tile, looping over query tiles:
//                dV += p^T dout,  dK += dS^T q
//   dq kernels:  one block per 64-query tile, looping over key tiles:
//                dQ += dS k
// Every output element belongs to one thread of one block and is summed in a
// fixed order, so there are no float atomics and two runs give the same bits.
//
// Head sizes 32, 64, 128 and 256 in both types, one launch a call for each
// kernel.  bf16 at D 128 and 256: the wgmma kernels, `flash_bwd_dkv_wgmma_kernel`
// and `flash_bwd_dq_wgmma_kernel` (a producer warp of TMA copies and two
// consumer warpgroups on wgmma, each score tile formed once; at D 128 a block
// owns 128 rows and each warpgroup 64 of them whole, at D 256 a block owns 64
// and the warpgroups split the work of a tile; see their notes).  fp32 at
// D 256: the split kernels, at D 128 the pair kernels, 8 warps a block, each
// score tile formed once (see their notes).
//
// The fp32 kernels and the bf16 ones up to D 64 share one block layout, 4
// warps a block.  dK/dV: each warp owns
// 16 keys of the block's 64-key tile as the rows of S^T = K q^T and
// dP^T = V dO^T, so that P^T and dS^T come out of the accumulators as the A
// operands of dV += P^T dO and dK += dS^T q without leaving registers; q and dO
// tiles are staged by cp.async.  dQ: each warp owns 16 queries of the block's
// 64-query tile as the rows of S = q K^T and dP = dO V^T, so that dS is the A
// operand of dQ += dS K; K and V tiles are staged by cp.async.  dQ, dK and dV
// stay fp32 in registers until they are stored.
//
// bf16 up to D 64, `flash_bwd_dkv_mma_kernel` and `flash_bwd_dq_mma_kernel`:
// mma.sync m16n8k16 with fp32 sums (flash_attention_mma.cuh) on XOR-swizzled bf16
// tiles; the accumulators of two neighbouring 8-wide n-tiles are, element for
// element, the A fragment of one 16-wide k-chunk of the next product; the
// second products read their B operand by ldmatrix.trans; the streamed tiles
// are double-buffered.
//
// fp32, `flash_bwd_dkv_tf32_kernel` and `flash_bwd_dq_tf32_kernel` (up to
// D 64; the D 128 pair and D 256 split kernels share their arithmetic):
// mma.sync m16n8k8 on TF32 in 3xTF32 (tf32x3.cuh): every fp32 operand is split into
// big + small, each k-chunk of 8 forms small.big, big.small and big.big in a
// fresh accumulator, and one round-to-nearest add puts that into the thread's
// fp32 sum (dK and dV sum over up to 4096 queries, 512 chunks: carried in one
// accumulator, the tensor cores' truncating sums drift to about 5e-5 of the
// largest magnitude at (1, 4096, 32, 64) on an H100, against 4e-6 flushed).
// The block's own tiles (K, V for dK/dV; q, dO for dQ) stay fp32 and each A
// fragment is split after its ldmatrix load; the other side's tiles, read as
// B operands by all four warps in both products, are split once per tile in
// shared memory into a big and a small half.  That costs a tile of shared
// memory per half, so they are staged in one stage, not two (two blocks a SM
// at D <= 64 overlap each other's copies).  The second products take p and dS
// from the score accumulators as their A operand through a permuted
// contraction index (B operand: dO or q rows for dK/dV, K rows for dQ), so p
// and dS never pass through shared memory; tiles, split and permutation:
// flash_attention_tf32.cuh, which the fp32 forward shares.
// p = expf(s * scale - lse), as the FMA kernels they replaced.
//
// What bounds them on the H100: the function is five T x T x D products
// (10 B H T^2 D operations); the split into two kernels recomputes q.k^T and
// dout.v^T, so seven are done: dK/dV four (8 pairs D operations), dQ three
// (6 pairs D).  bf16 is held against the 989 TFLOP/s dense bf16 peak; fp32
// does three TF32 products for each, against 494.7 / 3 = 165 TFLOP/s (2.46x
// the 67 TFLOP/s of the FMA pipe).  What holds the mma.sync kernels (bf16
// up to D 64, fp32 at every D) back from it: `mma.sync` rather
// than `wgmma`, every warp reading the whole staged tile of the other side
// from shared memory, cp.async rather than TMA, per-element work (exp,
// masks, dS) of the same order as the products at D 64, and in fp32 the
// splits (five integer and fp32 operations a word) and the flush adds (four
// a k-chunk, about a fifth of the fp32 kernels' time), issued beside the
// tensor cores by eight warps a SM, which registers (about 190 a thread at
// D 64) and shared memory both cap.  The design
// masks the ragged edge in the kernel (T is never padded), and skips a tile
// whose segment ids all lie outside the block's own [min, max] segment range
// without loading it.  With `causal` the tiles above the diagonal are skipped
// too: the dkv loop over query tiles starts at the key tile's own row, the dq
// loop over key tiles ends at the query tile's own column, and the diagonal
// tile is masked element by element; the dq kernels hand their query tiles
// out longest first (the dkv kernels' first key tile is their longest
// already).  At D 256 every kernel does its four (dK/dV) or three (dQ)
// products once, one block a SM.  bf16 at (1, 2048, 8, 256) causal: the
// products bound dK/dV at 0.0348 ms and dQ at 0.0261 over the 989 TFLOP/s
// bf16 peak; the mma.sync kernels these wgmma kernels replaced, run as dV
// and dK passes over two column halves (dK/dV, four launches) and over two
// halves (dQ), did eight and five products and took 1.002 and 0.603 ms
// (3.5 and 4.3 % of those bounds, NVIDIA H100 80GB HBM3, 700.00 W,
// `scripts/flash_kernel_times_torch.py`; the wgmma kernels' times are in
// PERF.md).  What still holds the wgmma kernels back: one block a SM, each
// warpgroup's elementwise work waiting on its score product and its
// gradient product on that work (no overlap of one tile's exp with the next
// tile's products), and the hand-over between the warpgroups, which puts
// the partner's elementwise work on the critical path.  The fp32 split
// kernels at D 256, 8 warps a block (one a SM), split every operand word as
// it is loaded (the price of two stages of streamed tiles in 216,064 B): at
// (1, 2048, 8, 256) causal dK/dV 1.570 / 1.519 ms and dQ 1.189 / 1.167 (13 /
// 13 % of their own bounds) where the passes and halves took 5.034 / 5.115
// and 2.872 / 2.844 (NVIDIA H100 80GB HBM3, 700.00 W,
// `scripts/flash_kernel_times_torch.py`); the pair kernels at D 128 the
// same way (see their notes).  Later work: TF32 wgmma for fp32,
// wgmma / TMA at D 32 and 64 in bf16, a fused five-product backward, and a
// GQA-aware kernel.

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"
#include "flash_attention_tf32.cuh"
#include "flash_attention_wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The bf16 dK/dV kernel on the tensor cores.  One block of 4 warps per 64-key
// tile; warp w owns keys 16 w .. 16 w + 15 whole, as the rows of
//   S^T = K Q^T  and  dP^T = V dO^T   (K and V held as A fragments),
// and loops over the visible 64-query tiles (from the diagonal with `causal`),
// 16 queries at a time:
//   P^T  = exp(S^T * scale - lse)            (0 where masked)
//   dS^T = P^T o (dP^T - delta) * scale      (from the unrounded P^T)
//   dV  += bf16(P^T) dO,   dK += bf16(dS^T) Q   (dO and Q read by ldmatrix.trans)
// so the probability tiles never leave registers.  Q, dO and their lse / delta
// rows are double-buffered by cp.async.  dK and dV stay fp32 in registers and
// are rounded once, as they are stored.  Each output element is one thread's
// and is summed in a fixed order: no atomics, two runs give the same bits.
// Up to D 64; at D 128 and 256 `flash_bwd_dkv_wgmma_kernel` runs instead.
// ---------------------------------------------------------------------------

namespace fa_mma = flash::mma;

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V, then Q and dO x 2; lse and delta rows x 2
  return sizeof(__nv_bfloat16) * fa_mma::ROWS * D * 6 + sizeof(float) * fa_mma::ROWS * 4;
}

template <int D>
__global__ void __launch_bounds__(fa_mma::THREADS)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int T, int H, float scale, int causal) {
  using namespace fa_mma;
  static_assert(D <= 64, "D 128 and 256 run flash_bwd_dkv_wgmma_kernel");
  constexpr int TILE_ELEMS = ROWS * D;
  constexpr int KC = D / 16;  // k-chunks of the two score products
  constexpr int NT = D / 8;   // n-tiles of dK and dV

  extern __shared__ uint4 smem_dkv[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_dkv);
  bf16* Vs = Ks + TILE_ELEMS;
  bf16* Qs = Vs + TILE_ELEMS;           // [2][ROWS][D]
  bf16* Os = Qs + 2 * TILE_ELEMS;       // [2][ROWS][D], dO
  float* lse_s = reinterpret_cast<float*>(Os + 2 * TILE_ELEMS);  // [2][ROWS]
  float* delta_s = lse_s + 2 * ROWS;                              // [2][ROWS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  int klo, khi;
  segment_range(segb, k0, T, lane, klo, khi);

  stage_tile<D>(Ks, k, base, ld, k0, T, tid);
  stage_tile<D>(Vs, v, base, ld, k0, T, tid);
  cp_async_commit();
  // causal: the query tiles before this key tile's own row see none of its keys
  bool uniform, uniform_next;
  int q0 = next_tile(segb, causal ? k0 : 0, T, T, klo, khi, lane, uniform);
  if (q0 < T) {
    stage_tile<D>(Qs, q, base, ld, q0, T, tid);
    stage_tile<D>(Os, dout, base, ld, q0, T, tid);
    stage_rows(lse_s, lse + row_base, q0, T, tid);
    stage_rows(delta_s, delta + row_base, q0, T, tid);
  }
  cp_async_commit();

  // this thread's two keys, rows g and g + 8 of the warp's 16
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const int seg0 = key0 < T ? segb[key0] : -1, seg1 = key1 < T ? segb[key1] : -1;

  cp_async_wait<1>();
  __syncthreads();
  uint32_t ka[KC][4], va[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    load_a<D>(ka[kc], Ks, warp * 16, kc, lane);
    load_a<D>(va[kc], Vs, warp * 16, kc, lane);
  }

  float acc_dk[NT][4], acc_dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_dk[j][e] = 0.f;
      acc_dv[j][e] = 0.f;
    }

  const float scale_log2 = scale * LOG2E;
  int stage = 0;
  while (q0 < T) {
    const int qn = next_tile(segb, q0 + ROWS, T, T, klo, khi, lane, uniform_next);
    if (qn < T) {
      const int nx = stage ^ 1;
      stage_tile<D>(Qs + nx * TILE_ELEMS, q, base, ld, qn, T, tid);
      stage_tile<D>(Os + nx * TILE_ELEMS, dout, base, ld, qn, T, tid);
      stage_rows(lse_s + nx * ROWS, lse + row_base, qn, T, tid);
      stage_rows(delta_s + nx * ROWS, delta + row_base, qn, T, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + stage * TILE_ELEMS;
    const bf16* Ot = Os + stage * TILE_ELEMS;
    const float* lse_t = lse_s + stage * ROWS;
    const float* delta_t = delta_s + stage * ROWS;
    // the ragged edge, the diagonal tile (q0 == k0) and a tile whose ids are
    // not all the key tile's single id are masked element by element
    const bool masked = !uniform || q0 + ROWS > T || (causal && q0 < k0 + ROWS);

#pragma unroll(ROWS / 16)
    for (int c = 0; c < ROWS / 16; ++c) {  // queries 16 c .. 16 c + 15 of the tile
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qb[4], ob[4];
        // both B loads before the products (a D 64 kernel that loaded dO
        // after S's products ran 10 to 15 % slower on an H100)
        load_b<D>(qb, Qt, c * 16, kc, lane);
        load_b<D>(ob, Ot, c * 16, kc, lane);
        mma_bf16(st[0], ka[kc], qb[0], qb[1]);
        mma_bf16(st[1], ka[kc], qb[2], qb[3]);
        mma_bf16(dpt[0], va[kc], ob[0], ob[1]);
        mma_bf16(dpt[1], va[kc], ob[2], ob[3]);
      }
      // element (n, e): key row e < 2 ? g : g + 8, query 16 c + 8 n + 2 t4 + (e & 1)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c * 16 + n * 8 + 2 * t4 + (e & 1);
          const float row_lse = lse_t[qc];
          float p = exp2f(fmaf(st[n][e], scale_log2, -row_lse * LOG2E));
          if (masked) {
            const int query = q0 + qc;
            const int key = e < 2 ? key0 : key1;
            const bool ok = query < T && segb[query] == (e < 2 ? seg0 : seg1) &&
                            (!causal || key <= query);
            p = ok ? p : 0.f;
          }
          dpt[n][e] = p * (dpt[n][e] - delta_t[qc]) * scale;  // dS^T, from the unrounded p
          st[n][e] = p;
        }
      }
      // the two n-tiles of queries 16 c .. 16 c + 15 are one A fragment
      const uint32_t pa[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
      const uint32_t sa[4] = {pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
                              pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t ob[4], qb[4];
        load_b_trans<D>(ob, Ot, c * 16, np, lane);
        mma_bf16(acc_dv[2 * np], pa, ob[0], ob[1]);
        mma_bf16(acc_dv[2 * np + 1], pa, ob[2], ob[3]);
        load_b_trans<D>(qb, Qt, c * 16, np, lane);
        mma_bf16(acc_dk[2 * np], sa, qb[0], qb[1]);
        mma_bf16(acc_dk[2 * np + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    q0 = qn;
    uniform = uniform_next;
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i == 0 ? key0 : key1;
    if (t < T) {
      const long at = base + (long)t * ld + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
            __floats2bfloat162_rn(acc_dk[j][2 * i], acc_dk[j][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
            __floats2bfloat162_rn(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 dQ kernel on the tensor cores.  One block of 4 warps per (64-query
// tile, head, batch row); warp w owns queries 16 w .. 16 w + 15 whole, as the
// rows of
//   S = Q K^T  and  dP = dO V^T   (Q and dO held as A fragments),
// and loops over the visible 64-key tiles (up to the diagonal with `causal`),
// 16 keys at a time:
//   P  = exp(S * scale - lse)              (0 where masked)
//   dS = P o (dP - delta) * scale          (from the unrounded P)
//   dQ += bf16(dS) K                       (K read by ldmatrix.trans)
// The two n-tiles of one 16-key chunk of dS are the A fragment of that chunk,
// so dS never leaves registers, and only one chunk of S and dP is live at a
// time.  Each thread keeps the lse and delta of its two rows in registers.
// K and V are double-buffered by cp.async.  dQ stays fp32 in registers and is
// rounded once, as it is stored; each element is one thread's and is summed in
// a fixed order: no atomics, two runs give the same bits.  Up to D 64; D 128
// and 256 run `flash_bwd_dq_wgmma_kernel`.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * fa_mma::ROWS * D * 6;  // Q, dO, then K and V x 2
}

// Blocks a SM: ptxas chose at most 168 registers (three blocks of 128
// threads) by itself, and the bound keeps that
template <int D>
__global__ void __launch_bounds__(fa_mma::THREADS, 3)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                        int T, int H, float scale, int causal) {
  using namespace fa_mma;
  static_assert(D <= 64, "D 128 and 256 run flash_bwd_dq_wgmma_kernel");
  constexpr int TILE_ELEMS = ROWS * D;
  constexpr int KC = D / 16;  // k-chunks of the two score products
  constexpr int NT = D / 8;   // n-tiles of dQ

  extern __shared__ uint4 smem_dq[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_dq);
  bf16* Os = Qs + TILE_ELEMS;      // dO
  bf16* Ks = Os + TILE_ELEMS;      // [2][ROWS][D]
  bf16* Vs = Ks + 2 * TILE_ELEMS;  // [2][ROWS][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  int qlo, qhi;
  segment_range(segb, q0, T, lane, qlo, qhi);
  // causal: the tiles past the diagonal tile (k0 == q0) hold no visible key
  const int k_end = causal ? min(T, q0 + ROWS) : T;

  stage_tile<D>(Qs, q, base, ld, q0, T, tid);
  stage_tile<D>(Os, dout, base, ld, q0, T, tid);
  cp_async_commit();
  bool uniform, uniform_next;
  int k0 = next_tile(segb, 0, k_end, T, qlo, qhi, lane, uniform);
  if (k0 < k_end) {  // always: every in-range query sees its own key
    stage_tile<D>(Ks, k, base, ld, k0, T, tid);
    stage_tile<D>(Vs, v, base, ld, k0, T, tid);
  }
  cp_async_commit();

  // this thread's two queries, rows g and g + 8 of the warp's 16; rows past T
  // are never stored
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;
  const float lse_l2[2] = {row0 < T ? lse[row_base + row0] * LOG2E : 0.f,
                           row1 < T ? lse[row_base + row1] * LOG2E : 0.f};
  const float row_delta[2] = {row0 < T ? delta[row_base + row0] : 0.f,
                              row1 < T ? delta[row_base + row1] : 0.f};

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[KC][4], oa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    load_a<D>(qa[kc], Qs, warp * 16, kc, lane);
    load_a<D>(oa[kc], Os, warp * 16, kc, lane);
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const float scale_log2 = scale * LOG2E;
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
    // the ragged edge, the diagonal tile and a tile whose ids are not all the
    // query tile's single id are masked element by element
    const bool masked = !uniform || k0 + ROWS > T || (causal && k0 + ROWS > q0);

#pragma unroll(ROWS / 16)
    for (int c = 0; c < ROWS / 16; ++c) {  // keys 16 c .. 16 c + 15 of the tile
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t kb[4], vb[4];
        load_b<D>(kb, Kt, c * 16, kc, lane);
        load_b<D>(vb, Vt, c * 16, kc, lane);
        mma_bf16(s[0], qa[kc], kb[0], kb[1]);
        mma_bf16(s[1], qa[kc], kb[2], kb[3]);
        mma_bf16(dp[0], oa[kc], vb[0], vb[1]);
        mma_bf16(dp[1], oa[kc], vb[2], vb[3]);
      }
      // element (n, e): query row e < 2 ? g : g + 8, key 16 c + 8 n + 2 t4 + (e & 1)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = exp2f(fmaf(s[n][e], scale_log2, -lse_l2[i]));
          if (masked) {
            const int key = k0 + c * 16 + n * 8 + 2 * t4 + (e & 1);
            const int row = i == 0 ? row0 : row1;
            const bool ok = key < T && segb[key] == (i == 0 ? seg0 : seg1) &&
                            (!causal || key <= row);
            p = ok ? p : 0.f;
          }
          dp[n][e] = p * (dp[n][e] - row_delta[i]) * scale;  // dS, from the unrounded p
        }
      }
      // the two n-tiles of keys 16 c .. 16 c + 15 are one A fragment
      const uint32_t sa[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t kb[4];
        load_b_trans<D>(kb, Kt, c * 16, np, lane);
        mma_bf16(acc[2 * np], sa, kb[0], kb[1]);
        mma_bf16(acc[2 * np + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    k0 = kn;
    uniform = uniform_next;
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i == 0 ? row0 : row1;
    if (t < T) {
      __nv_bfloat16* dst = dq + base + (long)t * ld + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 kernels on the tensor cores, 3xTF32 (see the notes at the top).
// Up to D 64: the block's own tiles (K and V for dK/dV, Q and dO for dQ)
// stay fp32 and each A fragment is split after its load; the streamed tiles
// of the other side, read as B operands by all four warps in both products,
// are split once per tile in shared memory into a big and a small half (TF32
// bit patterns).  At D 256 that layout would ask for 399,872 B (dK/dV) and
// 399,360 B (dQ) of shared memory (the card grants a block 232,448) and a
// whole row of dK and dV 256 accumulators a thread: see the D 256 kernels
// further down.  At D 128 it took 203,264 B (one stage, one block of 4 warps a
// SM) and 128 (dK/dV) and 64 (dQ) accumulators a thread, indexed at run time
// in the stack frame: see the D 128 pair kernels.
// ---------------------------------------------------------------------------

using namespace flash::tf32;

// ---------------------------------------------------------------------------
// The fp32 dK/dV kernel up to D 64.  One block of 4 warps per 64-key tile;
// warp w owns keys 16 w .. 16 w + 15 whole, as the rows of
//   S^T = K Q^T  and  dP^T = V dO^T   (K and V as A fragments),
// and loops over the visible 64-query tiles (from the diagonal with
// `causal`), 8 NQ queries at a time:
//   P^T  = exp(S^T * scale - lse)            (0 where masked)
//   dS^T = P^T o (dP^T - delta) * scale
//   dV  += P^T dO,   dK += dS^T Q             (dO and Q rows read permuted)
// Each query tile is staged by cp.async with its lse / delta rows and split in
// place; one stage, so the copies of the next tile wait for this one's
// products (two blocks a SM overlap each other's).
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkv_tf32_smem_bytes() {
  // K, V, then Q and dO as big and small halves; lse and delta rows
  return sizeof(float) * (6 * fa_mma::ROWS * (D + 4) + 2 * fa_mma::ROWS);
}

template <int D>
__global__ void __launch_bounds__(fa_mma::THREADS)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ seg,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ dout, float* __restrict__ dk,
                          float* __restrict__ dv, int T, int H, float scale, int causal) {
  using namespace fa_mma;
  static_assert(D <= 64, "D 128 runs flash_bwd_dkv_tf32_pair_kernel, D 256 the split kernel");
  constexpr int TW = ROWS * (D + 4);  // words of a staged tile or half
  constexpr int KC = D / 8;           // k-chunks of the score products
  constexpr int NT = D / 8;           // n-tiles of dK and dV
  constexpr int NQ = 4;               // 8-query n-tiles a chunk, in pairs

  extern __shared__ float4 smem_dkv_tf32[];
  float* Ks = reinterpret_cast<float*>(smem_dkv_tf32);
  float* Vs = Ks + TW;
  float* Qbig = Vs + TW;
  float* Qsmall = Qbig + TW;
  float* Obig = Qsmall + TW;  // dO
  float* Osmall = Obig + TW;
  float* lse_s = Osmall + TW;     // [ROWS]
  float* delta_s = lse_s + ROWS;  // [ROWS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  int klo, khi;
  segment_range(segb, k0, T, lane, klo, khi);

  stage_tile_f32<D>(Ks, k, base, ld, k0, T, tid);
  stage_tile_f32<D>(Vs, v, base, ld, k0, T, tid);
  cp_async_commit();
  // causal: the query tiles before this key tile's own row see none of its keys
  bool uniform, uniform_next;
  int q0 = next_tile(segb, causal ? k0 : 0, T, T, klo, khi, lane, uniform);

  // this thread's two keys, rows g and g + 8 of the warp's 16
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const int seg0 = key0 < T ? segb[key0] : -1, seg1 = key1 < T ? segb[key1] : -1;

  float acc_dk[NT][4], acc_dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  while (q0 < T) {
    stage_tile_f32<D>(Qbig, q, base, ld, q0, T, tid);
    stage_tile_f32<D>(Obig, dout, base, ld, q0, T, tid);
    stage_rows(lse_s, lse + row_base, q0, T, tid);
    stage_rows(delta_s, delta + row_base, q0, T, tid);
    cp_async_commit();
    const int qn = next_tile(segb, q0 + ROWS, T, T, klo, khi, lane, uniform_next);
    cp_async_wait<0>();
    __syncthreads();
    split_tile_f32<D>(Qbig, Qsmall, tid);
    split_tile_f32<D>(Obig, Osmall, tid);
    __syncthreads();
    // the ragged edge, the diagonal tile and a tile whose ids are not all the
    // key tile's single id are masked element by element
    const bool masked = !uniform || q0 + ROWS > T || (causal && q0 < k0 + ROWS);

#pragma unroll 1
    for (int c0 = 0; c0 < ROWS; c0 += 8 * NQ) {  // queries c0 .. c0 + 8 NQ - 1 of the tile
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t kb[4], ks[4], vb[4], vs[4];
        load_a_split<D>(kb, ks, Ks, warp * 16, kc, lane);
        load_a_split<D>(vb, vs, Vs, warp * 16, kc, lane);
#pragma unroll
        for (int n = 0; n < NQ; n += 2) {
          uint32_t qb[4], qs[4], ob[4], os[4];
          load_b2<D>(qb, Qbig, c0 + 8 * n, kc, lane);
          load_b2<D>(qs, Qsmall, c0 + 8 * n, kc, lane);
          load_b2<D>(ob, Obig, c0 + 8 * n, kc, lane);
          load_b2<D>(os, Osmall, c0 + 8 * n, kc, lane);
          mma_3xtf32(st[n], kb, ks, qb[0], qb[1], qs[0], qs[1]);
          mma_3xtf32(dpt[n], vb, vs, ob[0], ob[1], os[0], os[1]);
          mma_3xtf32(st[n + 1], kb, ks, qb[2], qb[3], qs[2], qs[3]);
          mma_3xtf32(dpt[n + 1], vb, vs, ob[2], ob[3], os[2], os[3]);
        }
      }
      // element (n, e): key row e < 2 ? g : g + 8, query c0 + 8 n + 2 t4 + (e & 1)
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + 8 * n + 2 * t4 + (e & 1);
          float p = expf(st[n][e] * scale - lse_s[qc]);
          if (masked) {
            const int query = q0 + qc;
            const int key = e < 2 ? key0 : key1;
            const bool ok = query < T && segb[query] == (e < 2 ? seg0 : seg1) &&
                            (!causal || key <= query);
            p = ok ? p : 0.f;
          }
          dpt[n][e] = p * (dpt[n][e] - delta_s[qc]) * scale;  // dS^T
          st[n][e] = p;
        }
      }
      // n-tile n of P^T and dS^T is the A operand of the k-chunk over its 8
      // queries: dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t pb[4], ps[4], sb[4], ss[4];
        acc_as_a(st[n], pb, ps);
        acc_as_a(dpt[n], sb, ss);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t ob[2], os[2], qb[2], qs[2];
          load_bt<D>(ob, Obig, c0 + 8 * n, j, g, t4);
          load_bt<D>(os, Osmall, c0 + 8 * n, j, g, t4);
          mma_3xtf32(acc_dv[j], pb, ps, ob[0], ob[1], os[0], os[1]);
          load_bt<D>(qb, Qbig, c0 + 8 * n, j, g, t4);
          load_bt<D>(qs, Qsmall, c0 + 8 * n, j, g, t4);
          mma_3xtf32(acc_dk[j], sb, ss, qb[0], qb[1], qs[0], qs[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this tile before the next is staged
    q0 = qn;
    uniform = uniform_next;
  }
  cp_async_wait<0>();  // K and V of a block that saw no query tile

  // element (j, e): key row e < 2 ? g : g + 8, head-dim column 8 j + 2 t4 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i == 0 ? key0 : key1;
    if (t < T) {
      const long at = base + (long)t * ld + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        *reinterpret_cast<float2*>(dk + at + 8 * j) =
            make_float2(acc_dk[j][2 * i], acc_dk[j][2 * i + 1]);
        *reinterpret_cast<float2*>(dv + at + 8 * j) =
            make_float2(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 dQ kernel up to D 64.  One block of 4 warps per (64-query tile,
// head, batch row); warp w owns queries 16 w .. 16 w + 15 whole, as the rows of
//   S = Q K^T  and  dP = dO V^T   (Q and dO as A fragments),
// and loops over the visible 64-key tiles (up to the diagonal with `causal`),
// 8 NK keys at a time:
//   P  = exp(S * scale - lse)              (0 where masked)
//   dS = P o (dP - delta) * scale
//   dQ += dS K                             (K rows read permuted)
// Each thread keeps the lse and delta of its two rows in registers.  Each key
// tile is staged by cp.async and split in place, one stage, as in dK/dV.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_tf32_smem_bytes() {
  // Q, dO, then K and V as big and small halves
  return sizeof(float) * 6 * fa_mma::ROWS * (D + 4);
}

template <int D>
__global__ void __launch_bounds__(fa_mma::THREADS)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seg,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ dout, float* __restrict__ dq, int T, int H,
                         float scale, int causal) {
  using namespace fa_mma;
  static_assert(D <= 64, "D 128 runs flash_bwd_dq_tf32_pair_kernel, D 256 the split kernel");
  constexpr int TW = ROWS * (D + 4);
  constexpr int KC = D / 8;  // k-chunks of the score products
  constexpr int NT = D / 8;  // n-tiles of dQ
  constexpr int NK = 4;      // 8-key n-tiles a chunk, in pairs

  extern __shared__ float4 smem_dq_tf32[];
  float* Qs = reinterpret_cast<float*>(smem_dq_tf32);
  float* Os = Qs + TW;  // dO
  float* Kbig = Os + TW;
  float* Ksmall = Kbig + TW;
  float* Vbig = Ksmall + TW;
  float* Vsmall = Vbig + TW;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  int qlo, qhi;
  segment_range(segb, q0, T, lane, qlo, qhi);
  // causal: the tiles past the query tile's last row hold no visible key
  const int k_end = causal ? min(T, q0 + ROWS) : T;

  stage_tile_f32<D>(Qs, q, base, ld, q0, T, tid);
  stage_tile_f32<D>(Os, dout, base, ld, q0, T, tid);
  cp_async_commit();
  bool uniform, uniform_next;
  int k0 = next_tile(segb, 0, k_end, T, qlo, qhi, lane, uniform);

  // this thread's two queries, rows g and g + 8 of the warp's 16; rows past T
  // are never stored
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;
  const float row_lse[2] = {row0 < T ? lse[row_base + row0] : 0.f,
                            row1 < T ? lse[row_base + row1] : 0.f};
  const float row_delta[2] = {row0 < T ? delta[row_base + row0] : 0.f,
                              row1 < T ? delta[row_base + row1] : 0.f};

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  while (k0 < k_end) {  // always entered: every in-range query sees its own key
    stage_tile_f32<D>(Kbig, k, base, ld, k0, T, tid);
    stage_tile_f32<D>(Vbig, v, base, ld, k0, T, tid);
    cp_async_commit();
    const int kn = next_tile(segb, k0 + ROWS, k_end, T, qlo, qhi, lane, uniform_next);
    cp_async_wait<0>();
    __syncthreads();
    split_tile_f32<D>(Kbig, Ksmall, tid);
    split_tile_f32<D>(Vbig, Vsmall, tid);
    __syncthreads();
    // the ragged edge, the diagonal tile and a tile whose ids are not all the
    // query tile's single id are masked element by element
    const bool masked = !uniform || k0 + ROWS > T || (causal && k0 + ROWS > q0);

#pragma unroll 1
    for (int c0 = 0; c0 < ROWS; c0 += 8 * NK) {  // keys c0 .. c0 + 8 NK - 1 of the tile
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qb[4], qs[4], ob[4], os[4];
        load_a_split<D>(qb, qs, Qs, warp * 16, kc, lane);
        load_a_split<D>(ob, os, Os, warp * 16, kc, lane);
#pragma unroll
        for (int n = 0; n < NK; n += 2) {
          uint32_t kb[4], ks[4], vb[4], vs[4];
          load_b2<D>(kb, Kbig, c0 + 8 * n, kc, lane);
          load_b2<D>(ks, Ksmall, c0 + 8 * n, kc, lane);
          load_b2<D>(vb, Vbig, c0 + 8 * n, kc, lane);
          load_b2<D>(vs, Vsmall, c0 + 8 * n, kc, lane);
          mma_3xtf32(s[n], qb, qs, kb[0], kb[1], ks[0], ks[1]);
          mma_3xtf32(dp[n], ob, os, vb[0], vb[1], vs[0], vs[1]);
          mma_3xtf32(s[n + 1], qb, qs, kb[2], kb[3], ks[2], ks[3]);
          mma_3xtf32(dp[n + 1], ob, os, vb[2], vb[3], vs[2], vs[3]);
        }
      }
      // element (n, e): query row e < 2 ? g : g + 8, key c0 + 8 n + 2 t4 + (e & 1)
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = expf(s[n][e] * scale - row_lse[i]);
          if (masked) {
            const int key = k0 + c0 + 8 * n + 2 * t4 + (e & 1);
            const int row = i == 0 ? row0 : row1;
            const bool ok = key < T && segb[key] == (i == 0 ? seg0 : seg1) &&
                            (!causal || key <= row);
            p = ok ? p : 0.f;
          }
          dp[n][e] = p * (dp[n][e] - row_delta[i]) * scale;  // dS
        }
      }
      // n-tile n of dS is the A operand of the k-chunk over its 8 keys
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t sb[4], ss[4];
        acc_as_a(dp[n], sb, ss);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t kb[2], ks[2];
          load_bt<D>(kb, Kbig, c0 + 8 * n, j, g, t4);
          load_bt<D>(ks, Ksmall, c0 + 8 * n, j, g, t4);
          mma_3xtf32(acc[j], sb, ss, kb[0], kb[1], ks[0], ks[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this tile before the next is staged
    k0 = kn;
    uniform = uniform_next;
  }

  // element (j, e): query row e < 2 ? g : g + 8, head-dim column 8 j + 2 t4 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i == 0 ? row0 : row1;
    if (t < T) {
      float* dst = dq + base + (long)t * ld + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 kernels at D 256: each score tile formed once, one launch each.
// A block of 8 warps; each warp owns 16 rows x 128 columns of one output
// (64 accumulators a thread, no spill), so the two column halves of a row
// are two warps, and the score products S and dP are split between the
// warps that need them along their contraction over D: each warp forms the
// half of a 16-row score tile that its own 128 columns of the operands give,
// writes that partial sum to shared memory, and after a barrier of its
// group adds its partner's in a fixed order (columns 0..127 first, then
// 128..255), so that every warp of the group holds the whole tile, bit for
// bit the same.  The score tiles' accumulators are then the A operands of
// the gradient products through the permuted contraction index, as at D 64
// and 128.  Every operand word is kept unsplit in shared memory and split as
// it is loaded, which leaves the room for two stages of streamed tiles: the
// next tile's cp.async runs under this tile's products.  `tests/
// test_torch_flash_tf32.py` emulates this walk (`D256_WALK`): the split sums
// hold the fp32 bar, and plain TF32 fails it.
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 256;  // 8 warps
constexpr int SPLIT_KEYS = 32;      // dK/dV: keys of a block, queries of a streamed tile
constexpr int SPLIT_DQ_KEYS = 16;   // dQ: keys of a streamed tile (64 queries a block)

template <int D>
constexpr size_t dkv_split_smem_bytes() {
  // K, V (32 keys); Q and dO x 2 stages (32 queries); partial score tiles of
  // the two key groups: 4 of 16 x 32 each
  return sizeof(float) * (6 * SPLIT_KEYS * (D + 4) + 2 * 4 * 16 * SPLIT_KEYS);
}

// dK/dV at D 256.  One block per 32-key tile; warp w: key group kg = w / 4
// (keys 16 kg .. 16 kg + 15 of the tile), role w % 4: dV columns 0..127,
// dV 128..255, dK 0..127, dK 128..255 (half hf = role % 2).  Per 32-query
// tile (from the diagonal with `causal`):
//   dV warps: S^T's half hf = K[:, hf] Q[:, hf]^T;  dK warps: dP^T's half hf
//   = V[:, hf] dO[:, hf]^T   (4 query n-tiles, 16 k-chunks of 8)
//   exchange; S^T = half 0 + half 1 (every warp), dP^T likewise (dK warps)
//   P^T = exp(S^T * scale - lse), dS^T = P^T o (dP^T - delta) * scale
//   dV[:, hf] += P^T dO[:, hf]  or  dK[:, hf] += dS^T Q[:, hf]
// lse and delta of a tile's queries are read from device memory (L1).
template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
flash_bwd_dkv_tf32_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const int* __restrict__ seg,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                const float* __restrict__ dout, float* __restrict__ dk,
                                float* __restrict__ dv, int T, int H, float scale, int causal) {
  using namespace fa_mma;
  static_assert(D == 256, "the split form is built for D 256");
  constexpr int R = SPLIT_KEYS;      // keys of the block, queries of a streamed tile
  constexpr int TW = R * (D + 4);    // words of a tile
  constexpr int KC = D / 16;         // k-chunks of a score product's half
  constexpr int NQ = R / 8;          // query n-tiles of a score tile
  constexpr int NT = D / 16;         // n-tiles of a warp's 128 output columns

  extern __shared__ float4 smem_dkv_split[];
  float* Ks = reinterpret_cast<float*>(smem_dkv_split);
  float* Vs = Ks + TW;
  float* Qs = Vs + TW;       // [2 stages][R][D + 4]
  float* Os = Qs + 2 * TW;   // dO, [2 stages][R][D + 4]
  float* Xs = Os + 2 * TW;   // [2 key groups][4 roles][16 values][32 lanes]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kg = warp >> 2, role = warp & 3, hf = role & 1;
  const bool is_dk = role >= 2;
  const int k0 = blockIdx.x * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const float* lse_b = lse + ((long)b * H + h) * T;
  const float* delta_b = delta + ((long)b * H + h) * T;

  int klo, khi;
  segment_range<R>(segb, k0, T, lane, klo, khi);

  stage_tile_f32<D, R, SPLIT_THREADS>(Ks, k, base, ld, k0, T, tid);
  stage_tile_f32<D, R, SPLIT_THREADS>(Vs, v, base, ld, k0, T, tid);
  // causal: the query tiles before this key tile's own row see none of its keys
  bool uniform, uniform_next;
  int q0 = next_tile<R>(segb, causal ? k0 : 0, T, T, klo, khi, lane, uniform);
  if (q0 < T) {
    stage_tile_f32<D, R, SPLIT_THREADS>(Qs, q, base, ld, q0, T, tid);
    stage_tile_f32<D, R, SPLIT_THREADS>(Os, dout, base, ld, q0, T, tid);
  }
  cp_async_commit();

  // this thread's two keys, rows g and g + 8 of its group's 16
  const int key0 = k0 + 16 * kg + g, key1 = key0 + 8;
  const int seg0 = key0 < T ? segb[key0] : -1, seg1 = key1 < T ? segb[key1] : -1;
  // the score half this warp forms: S^T (K, Q) or dP^T (V, dO); the operand
  // of its gradient product: dO or Q
  const float* a_tile = is_dk ? Vs : Ks;
  float* xg = Xs + kg * 4 * 16 * 32;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
  while (q0 < T) {
    const int qn = next_tile<R>(segb, q0 + R, T, T, klo, khi, lane, uniform_next);
    if (qn < T) {
      stage_tile_f32<D, R, SPLIT_THREADS>(Qs + (stage ^ 1) * TW, q, base, ld, qn, T, tid);
      stage_tile_f32<D, R, SPLIT_THREADS>(Os + (stage ^ 1) * TW, dout, base, ld, qn, T, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qt = Qs + stage * TW;
    const float* Ot = Os + stage * TW;
    // the ragged edge, the tiles on the diagonal and a tile whose ids are not
    // all the key tile's single id are masked element by element
    const bool masked = !uniform || q0 + R > T || (causal && q0 < k0 + R);

    // this warp's half of S^T or dP^T: element (n, e) at key row e < 2 ? g :
    // g + 8, query 8 n + 2 t4 + (e & 1)
    float part[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
    const float* b_tile = is_dk ? Ot : Qt;
#pragma unroll 2
    for (int kc = 0; kc < KC; ++kc) {
      const int chunk = KC * hf + kc;  // 8-column chunk of the row
      uint32_t ab[4], as[4];
      load_a_split<D>(ab, as, a_tile, 16 * kg, chunk, lane);
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t bb[4], bs[4];
        load_b2_split<D>(bb, bs, b_tile, 8 * n, chunk, lane);
        mma_3xtf32(part[n], ab, as, bb[0], bb[1], bs[0], bs[1]);
        mma_3xtf32(part[n + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xg[(role * 16 + 4 * n + e) * 32 + lane] = part[n][e];
    group_sync(1 + kg, 128);

    // per query n-tile: the whole tile, half 0 + half 1, then P^T (dV warps)
    // or dS^T (dK warps) as the A operand of the k-chunk over its 8 queries:
    // dV[:, hf] += P^T dO[:, hf]  or  dK[:, hf] += dS^T Q[:, hf]
    const float* g_tile = (is_dk ? Qt : Ot) + (D / 2) * hf;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      float pt[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        const float st = xg[i * 32 + lane] + xg[(16 + i) * 32 + lane];
        const int query = q0 + 8 * n + 2 * t4 + (e & 1);
        const bool in = query < T;
        float p = expf(st * scale - (in ? lse_b[query] : 0.f));
        if (masked) {
          const int key = e < 2 ? key0 : key1;
          const bool ok = in && segb[query] == (e < 2 ? seg0 : seg1) &&
                          (!causal || key <= query);
          p = ok ? p : 0.f;
        }
        if (is_dk) {
          const float dpt = xg[(32 + i) * 32 + lane] + xg[(48 + i) * 32 + lane];
          p = p * (dpt - (in ? delta_b[query] : 0.f)) * scale;  // dS^T
        }
        pt[e] = p;
      }
      uint32_t pb[4], ps[4];
      acc_as_a(pt, pb, ps);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bb[2], bs[2];
        load_bt_split<D>(bb, bs, g_tile, 8 * n, j, g, t4);
        mma_3xtf32(acc[j], pb, ps, bb[0], bb[1], bs[0], bs[1]);
      }
    }
    __syncthreads();  // every warp is done with this stage and the partials
    q0 = qn;
    uniform = uniform_next;
    stage ^= 1;
  }
  cp_async_wait<0>();  // K and V of a block that saw no query tile

  // element (j, e): key row e < 2 ? g : g + 8, head-dim column
  // 128 hf + 8 j + 2 t4 + (e & 1)
  float* out = is_dk ? dk : dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i == 0 ? key0 : key1;
    if (t < T) {
      float* dst = out + base + (long)t * ld + (D / 2) * hf + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_split_smem_bytes() {
  // Q, dO (64 queries); K and V x 2 stages (16 keys); partial score tiles of
  // the four query groups: 2 warps x (S, dP) of 16 x 8 each
  return sizeof(float) *
         ((2 * fa_mma::ROWS + 4 * SPLIT_DQ_KEYS) * (D + 4) + 4 * 2 * 16 * 32);
}

// dQ at D 256.  One block per (64-query tile, head, batch row); warp w: query
// group qg = w / 2 (queries 16 qg .. 16 qg + 15), dQ columns 128 hf ..
// 128 hf + 127 with hf = w % 2.  Per 16-key tile (up to the diagonal with
// `causal`):
//   S's and dP's half hf = Q[:, hf] K[:, hf]^T, dO[:, hf] V[:, hf]^T
//   exchange with the partner warp; S = half 0 + half 1, dP likewise
//   P = exp(S * scale - lse), dS = P o (dP - delta) * scale
//   dQ[:, hf] += dS K[:, hf]
template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
flash_bwd_dq_tf32_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const int* __restrict__ seg,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const float* __restrict__ dout, float* __restrict__ dq, int T,
                               int H, float scale, int causal) {
  using namespace fa_mma;
  static_assert(D == 256, "the split form is built for D 256");
  constexpr int R = SPLIT_DQ_KEYS;    // keys of a streamed tile
  constexpr int QW = ROWS * (D + 4);  // words of the Q or dO tile
  constexpr int KW = R * (D + 4);     // words of a K or V tile
  constexpr int KC = D / 16;          // k-chunks of a score product's half
  constexpr int NK = R / 8;           // key n-tiles of a score tile
  constexpr int NT = D / 16;          // n-tiles of a warp's 128 columns of dQ

  extern __shared__ float4 smem_dq_split[];
  float* Qs = reinterpret_cast<float*>(smem_dq_split);
  float* Os = Qs + QW;      // dO
  float* Ks = Os + QW;      // [2 stages][R][D + 4]
  float* Vs = Ks + 2 * KW;  // [2 stages][R][D + 4]
  float* Xs = Vs + 2 * KW;  // [4 query groups][2 halves][S 8, dP 8][32 lanes]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qg = warp >> 1, hf = warp & 1;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  int qlo, qhi;
  segment_range(segb, q0, T, lane, qlo, qhi);
  // causal: the tiles past the query tile's last row hold no visible key
  const int k_end = causal ? min(T, q0 + ROWS) : T;

  stage_tile_f32<D, ROWS, SPLIT_THREADS>(Qs, q, base, ld, q0, T, tid);
  stage_tile_f32<D, ROWS, SPLIT_THREADS>(Os, dout, base, ld, q0, T, tid);
  bool uniform, uniform_next;
  int k0 = next_tile<R>(segb, 0, k_end, T, qlo, qhi, lane, uniform);
  if (k0 < k_end) {  // always: every in-range query sees its own key
    stage_tile_f32<D, R, SPLIT_THREADS>(Ks, k, base, ld, k0, T, tid);
    stage_tile_f32<D, R, SPLIT_THREADS>(Vs, v, base, ld, k0, T, tid);
  }
  cp_async_commit();

  // this thread's two queries, rows g and g + 8 of its group's 16; rows past T
  // are never stored
  const int row0 = q0 + 16 * qg + g, row1 = row0 + 8;
  const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;
  const float row_lse[2] = {row0 < T ? lse[row_base + row0] : 0.f,
                            row1 < T ? lse[row_base + row1] : 0.f};
  const float row_delta[2] = {row0 < T ? delta[row_base + row0] : 0.f,
                              row1 < T ? delta[row_base + row1] : 0.f};
  float* xg = Xs + qg * 2 * 16 * 32;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
  while (k0 < k_end) {
    const int kn = next_tile<R>(segb, k0 + R, k_end, T, qlo, qhi, lane, uniform_next);
    if (kn < k_end) {
      stage_tile_f32<D, R, SPLIT_THREADS>(Ks + (stage ^ 1) * KW, k, base, ld, kn, T, tid);
      stage_tile_f32<D, R, SPLIT_THREADS>(Vs + (stage ^ 1) * KW, v, base, ld, kn, T, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + stage * KW;
    const float* Vt = Vs + stage * KW;
    // the ragged edge, the tiles on the diagonal and a tile whose ids are not
    // all the query tile's single id are masked element by element
    const bool masked = !uniform || k0 + R > T || (causal && k0 + R > q0);

    // this warp's halves of S and dP: element (n, e) at query row e < 2 ? g :
    // g + 8, key 8 n + 2 t4 + (e & 1)
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < KC; ++kc) {
      const int chunk = KC * hf + kc;  // 8-column chunk of the row
      uint32_t qb[4], qs[4], ob[4], os[4], kb[4], ks[4], vb[4], vs[4];
      load_a_split<D>(qb, qs, Qs, 16 * qg, chunk, lane);
      load_a_split<D>(ob, os, Os, 16 * qg, chunk, lane);
      load_b2_split<D>(kb, ks, Kt, 0, chunk, lane);
      load_b2_split<D>(vb, vs, Vt, 0, chunk, lane);
      mma_3xtf32(s[0], qb, qs, kb[0], kb[1], ks[0], ks[1]);
      mma_3xtf32(dp[0], ob, os, vb[0], vb[1], vs[0], vs[1]);
      mma_3xtf32(s[1], qb, qs, kb[2], kb[3], ks[2], ks[3]);
      mma_3xtf32(dp[1], ob, os, vb[2], vb[3], vs[2], vs[3]);
    }
    float* mine = xg + hf * 16 * 32;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(4 * n + e) * 32 + lane] = s[n][e];
        mine[(8 + 4 * n + e) * 32 + lane] = dp[n][e];
      }
    group_sync(1 + qg, 64);

    // the whole tiles, half 0 + half 1; then P and dS
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e, r = e >> 1;
        const float st = xg[i * 32 + lane] + xg[(16 + i) * 32 + lane];
        const float dpt = xg[(8 + i) * 32 + lane] + xg[(24 + i) * 32 + lane];
        float p = expf(st * scale - row_lse[r]);
        if (masked) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          const int row = r == 0 ? row0 : row1;
          const bool ok = key < T && segb[key] == (r == 0 ? seg0 : seg1) &&
                          (!causal || key <= row);
          p = ok ? p : 0.f;
        }
        dp[n][e] = p * (dpt - row_delta[r]) * scale;  // dS
      }
    }
    // n-tile n of dS is the A operand of the k-chunk over its 8 keys
    const float* g_tile = Kt + (D / 2) * hf;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t sb[4], ss[4];
      acc_as_a(dp[n], sb, ss);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t kb[2], ks[2];
        load_bt_split<D>(kb, ks, g_tile, 8 * n, j, g, t4);
        mma_3xtf32(acc[j], sb, ss, kb[0], kb[1], ks[0], ks[1]);
      }
    }
    __syncthreads();  // every warp is done with this stage and the partials
    k0 = kn;
    uniform = uniform_next;
    stage ^= 1;
  }

  // element (j, e): query row e < 2 ? g : g + 8, head-dim column
  // 128 hf + 8 j + 2 t4 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i == 0 ? row0 : row1;
    if (t < T) {
      float* dst = dq + base + (long)t * ld + (D / 2) * hf + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 kernels at D 128: each score tile formed once, one launch each.
// They replace the same upstream kernels as every kernel here,
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`, causal from
// roar_tpu/models/gpt.py:491-535 at head size 128 (and 80 and 100, padded).
// A block of 8 warps in 4 row groups of 16 rows; warp w belongs to group
// w % 4 with role w / 4.  The two warps of a group each form one score tile
// over the whole of D (16 k-chunks of 8: the D 256 split kernels' walk with
// `parts` 1) and hand across shared memory what the other needs of it,
// behind a named barrier of the pair.  Each warp's output is at most 64
// accumulators a thread, indexed by constants only: no stack frame.  Every
// operand word is kept unsplit in shared memory and split as it is loaded,
// as in the split kernels, which leaves the room for two stages of streamed
// tiles: the next tile's cp.async runs under this tile's products.  Sums as
// in every fp32 kernel: 3xTF32 per k-chunk, flushed into the thread's fp32
// sum; the score products over D in k-chunk order, the gradient products
// over the streamed rows in walk order (from the diagonal for dK/dV, up to
// it for dQ), so two runs give the same bits, the 4-warp kernels' bits
// before them.  `tests/test_torch_flash_tf32.py` emulates this walk
// (`D128_WALK`).
//
// What bounds them on the H100: at (1, 4096, 32, 128) causal their own
// products, 1.667 ms (dK/dV, four) and 1.251 (dQ, three) over the 3xTF32
// rate.  The 4-warp kernels they replace took 15.9 and 11.2 ms (10.5 and
// 11.1 %): 128 (dK/dV) and 64 (dQ) accumulators a thread indexed at run time
// in the stack frame, the streamed tiles' split halves filling 203 KB (one
// stage, 4 warps a SM).  These take 6.74 to 6.93 and 5.37 to 5.45 ms (24 to
// 25 and 23 %; NVIDIA H100 80GB HBM3, 700.00 W,
// `scripts/flash_kernel_times_torch.py` in turns with them).  What is left:
// mma.sync rather than wgmma, the integer splits of every loaded word (each
// streamed tile split alike by the 4 row groups) and the flush adds beside
// the tensor cores, and one block of 8 warps a SM.
// ---------------------------------------------------------------------------

constexpr int PAIR_THREADS = 256;  // 8 warps: 4 row groups x 2 roles
constexpr int PAIR_DQ_KEYS = 32;   // dQ: keys of a streamed tile

template <int D>
constexpr size_t dkv_pair_smem_bytes() {
  // K, V; Q and dO x 2 stages (64 rows each); P^T of the 4 key groups (16 x
  // 64 each); lse and delta rows x 2 stages; dS^T of a half tile of the 4 key
  // groups (16 x 32 each): 228,352 B at D 128
  return sizeof(float) * (6 * fa_mma::ROWS * (D + 4) + 4 * 16 * fa_mma::ROWS +
                          4 * fa_mma::ROWS + 4 * 16 * 32);
}

// dK/dV at D 128.  One block per 64-key tile; group kg owns keys 16 kg ..
// 16 kg + 15.  Per 64-query tile (from the diagonal with `causal`), its two
// halves of 32 queries in turn:
//   dV warp: S^T = K Q^T, P^T = exp(S^T * scale - lse) (0 where masked),
//            P^T handed over;                          dV += P^T dO
//   dK warp: dP^T = V dO^T, takes P^T,
//            dS^T = P^T o (dP^T - delta) * scale;      dK += dS^T Q
// Q, dO and their lse and delta rows are staged by cp.async in two stages.
// A 64-query score tile (32 registers) or the gradient product's loop over
// its n-tiles unrolled made ptxas spill (255 registers; 36 to 76 bytes), so
// a half is one score tile of 16 registers, and the gradient product reads
// its A operand back from shared memory an n-tile at a time (250 registers
// with the score product's k-chunks unrolled 4 times, 208 with 2).
template <int D>
__global__ void __launch_bounds__(PAIR_THREADS, 1)
flash_bwd_dkv_tf32_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const int* __restrict__ seg,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const float* __restrict__ dout, float* __restrict__ dk,
                               float* __restrict__ dv, int T, int H, float scale, int causal) {
  using namespace fa_mma;
  static_assert(D == 128, "the pair form is built for D 128");
  constexpr int TW = ROWS * (D + 4);  // words of a tile
  constexpr int KC = D / 8;           // k-chunks of a score product
  constexpr int NQ = 4;               // query n-tiles of a half tile's score tile
  constexpr int NT = D / 8;           // n-tiles of a warp's output rows

  extern __shared__ float4 smem_dkv_pair[];
  float* Ks = reinterpret_cast<float*>(smem_dkv_pair);
  float* Vs = Ks + TW;
  float* Qs = Vs + TW;                      // [2 stages][ROWS][D + 4]
  float* Os = Qs + 2 * TW;                  // dO, [2 stages][ROWS][D + 4]
  float* Ps = Os + 2 * TW;                  // P^T, [4 key groups][2 halves][4 NQ][32 lanes]
  float* lse_s = Ps + 4 * 2 * 4 * NQ * 32;  // [2 stages][ROWS]
  float* delta_s = lse_s + 2 * ROWS;        // [2 stages][ROWS]
  float* Ds = delta_s + 2 * ROWS;           // dS^T of a half, [4 key groups][4 NQ][32 lanes]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kg = warp & 3;
  const bool is_dk = warp >= 4;
  const int k0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  int klo, khi;
  segment_range(segb, k0, T, lane, klo, khi);

  stage_tile_f32<D, ROWS, PAIR_THREADS>(Ks, k, base, ld, k0, T, tid);
  stage_tile_f32<D, ROWS, PAIR_THREADS>(Vs, v, base, ld, k0, T, tid);
  // causal: the query tiles before this key tile's own row see none of its keys
  bool uniform, uniform_next;
  int q0 = next_tile(segb, causal ? k0 : 0, T, T, klo, khi, lane, uniform);
  if (q0 < T) {
    stage_tile_f32<D, ROWS, PAIR_THREADS>(Qs, q, base, ld, q0, T, tid);
    stage_tile_f32<D, ROWS, PAIR_THREADS>(Os, dout, base, ld, q0, T, tid);
    stage_rows(lse_s, lse + row_base, q0, T, tid);
    stage_rows(delta_s, delta + row_base, q0, T, tid);
  }
  cp_async_commit();

  // this thread's two keys, rows g and g + 8 of its group's 16
  const int key0 = k0 + 16 * kg + g, key1 = key0 + 8;
  const int seg0 = key0 < T ? segb[key0] : -1, seg1 = key1 < T ? segb[key1] : -1;
  // the operand of this warp's score tile that the block keeps: K or V
  const float* a_tile = is_dk ? Vs : Ks;
  float* pt_s = Ps + kg * 2 * 4 * NQ * 32;
  float* ds_s = Ds + kg * 4 * NQ * 32;  // the dK warp's own

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
  while (q0 < T) {
    const int qn = next_tile(segb, q0 + ROWS, T, T, klo, khi, lane, uniform_next);
    if (qn < T) {
      const int nx = stage ^ 1;
      stage_tile_f32<D, ROWS, PAIR_THREADS>(Qs + nx * TW, q, base, ld, qn, T, tid);
      stage_tile_f32<D, ROWS, PAIR_THREADS>(Os + nx * TW, dout, base, ld, qn, T, tid);
      stage_rows(lse_s + nx * ROWS, lse + row_base, qn, T, tid);
      stage_rows(delta_s + nx * ROWS, delta + row_base, qn, T, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qt = Qs + stage * TW;
    const float* Ot = Os + stage * TW;
    const float* lse_t = lse_s + stage * ROWS;
    const float* delta_t = delta_s + stage * ROWS;
    // the ragged edge, the diagonal tile and a tile whose ids are not all the
    // key tile's single id are masked element by element
    const bool masked = !uniform || q0 + ROWS > T || (causal && q0 < k0 + ROWS);

    // two halves of 32 queries in turn, each with its own named barrier of
    // the pair (1 + kg, then 5 + kg), so that a score tile is 16 registers
    const float* b_tile = is_dk ? Ot : Qt;
    const float* g_tile = is_dk ? Qt : Ot;
#pragma unroll 1
    for (int hq = 0; hq < 2; ++hq) {
      const int c0 = 32 * hq;  // queries c0 .. c0 + 31 of the tile
      // S^T (dV warps) or dP^T (dK warps): element (n, e) at key row e < 2 ?
      // g : g + 8, query c0 + 8 n + 2 t4 + (e & 1)
      float sc[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll 4
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ab[4], as[4];
        load_a_split<D>(ab, as, a_tile, 16 * kg, kc, lane);
#pragma unroll
        for (int n = 0; n < NQ; n += 2) {
          uint32_t bb[4], bs[4];
          load_b2_split<D>(bb, bs, b_tile, c0 + 8 * n, kc, lane);
          mma_3xtf32(sc[n], ab, as, bb[0], bb[1], bs[0], bs[1]);
          mma_3xtf32(sc[n + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
        }
      }
      float* pt_h = pt_s + hq * 4 * NQ * 32;
      if (!is_dk) {
        // P^T, kept and handed to the group's dK warp
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c0 + 8 * n + 2 * t4 + (e & 1);
            float p = expf(sc[n][e] * scale - lse_t[qc]);
            if (masked) {
              const int query = q0 + qc;
              const int key = e < 2 ? key0 : key1;
              const bool ok = query < T && segb[query] == (e < 2 ? seg0 : seg1) &&
                              (!causal || key <= query);
              p = ok ? p : 0.f;
            }
            pt_h[(4 * n + e) * 32 + lane] = p;
          }
        }
        group_arrive(1 + kg + 4 * hq, 64);
      } else {
        group_sync(1 + kg + 4 * hq, 64);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c0 + 8 * n + 2 * t4 + (e & 1);
            const float p = pt_h[(4 * n + e) * 32 + lane];
            ds_s[(4 * n + e) * 32 + lane] = p * (sc[n][e] - delta_t[qc]) * scale;  // dS^T
          }
        }
      }
      // n-tile n of P^T (dV warps) or dS^T (dK warps) is the A operand of the
      // k-chunk over its 8 queries: dV += P^T dO or dK += dS^T Q.  Each lane
      // reads its own values back from shared memory, an n-tile at a time, so
      // that the loop over n-tiles stays rolled
      const float* a_h = is_dk ? ds_s : pt_h;
#pragma unroll 1
      for (int n = 0; n < NQ; ++n) {
        const float a[4] = {a_h[(4 * n) * 32 + lane], a_h[(4 * n + 1) * 32 + lane],
                            a_h[(4 * n + 2) * 32 + lane], a_h[(4 * n + 3) * 32 + lane]};
        uint32_t pb[4], ps[4];
        acc_as_a(a, pb, ps);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bb[2], bs[2];
          load_bt_split<D>(bb, bs, g_tile, c0 + 8 * n, j, g, t4);
          mma_3xtf32(acc[j], pb, ps, bb[0], bb[1], bs[0], bs[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and with P^T
    q0 = qn;
    uniform = uniform_next;
    stage ^= 1;
  }
  cp_async_wait<0>();  // K and V of a block that saw no query tile

  // element (j, e): key row e < 2 ? g : g + 8, head-dim column 8 j + 2 t4 + (e & 1)
  float* out = is_dk ? dk : dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i == 0 ? key0 : key1;
    if (t < T) {
      float* dst = out + base + (long)t * ld + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_pair_smem_bytes() {
  // Q, dO (64 queries); K and V x 2 stages (32 keys); the P and dP tiles of
  // the 4 query groups (16 x 32 each): 151,552 B at D 128
  return sizeof(float) *
         ((2 * fa_mma::ROWS + 4 * PAIR_DQ_KEYS) * (D + 4) + 4 * 2 * 16 * PAIR_DQ_KEYS);
}

// dQ at D 128.  One block per (64-query tile, head, batch row); group qg
// owns queries 16 qg .. 16 qg + 15.  Per 32-key tile (up to the diagonal
// with `causal`):
//   role 0: S = Q K^T, P = exp(S * scale - lse) (0 where masked);
//   role 1: dP = dO V^T
//   P and dP swapped; both: dS = P o (dP - delta) * scale, the same bits
//   role r: dQ[:, 64 r .. 64 r + 63] += dS K[:, 64 r ..]
// K and V are staged by cp.async in two stages.
template <int D>
__global__ void __launch_bounds__(PAIR_THREADS, 1)
flash_bwd_dq_tf32_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int* __restrict__ seg,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const float* __restrict__ dout, float* __restrict__ dq, int T,
                              int H, float scale, int causal) {
  using namespace fa_mma;
  static_assert(D == 128, "the pair form is built for D 128");
  constexpr int R = PAIR_DQ_KEYS;     // keys of a streamed tile
  constexpr int QW = ROWS * (D + 4);  // words of the Q or dO tile
  constexpr int KW = R * (D + 4);     // words of a K or V tile
  constexpr int KC = D / 8;           // k-chunks of a score product
  constexpr int NK = R / 8;           // key n-tiles of a score tile
  constexpr int NT = D / 16;          // n-tiles of a warp's 64 columns of dQ
  constexpr int XW = 4 * NK * 32;     // words of one warp's score tile

  extern __shared__ float4 smem_dq_pair[];
  float* Qs = reinterpret_cast<float*>(smem_dq_pair);
  float* Os = Qs + QW;      // dO
  float* Ks = Os + QW;      // [2 stages][R][D + 4]
  float* Vs = Ks + 2 * KW;  // [2 stages][R][D + 4]
  float* Xs = Vs + 2 * KW;  // [4 query groups][2 roles][4 NK values][32 lanes]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qg = warp & 3, role = warp >> 2;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  int qlo, qhi;
  segment_range(segb, q0, T, lane, qlo, qhi);
  // causal: the tiles past the query tile's last row hold no visible key
  const int k_end = causal ? min(T, q0 + ROWS) : T;

  stage_tile_f32<D, ROWS, PAIR_THREADS>(Qs, q, base, ld, q0, T, tid);
  stage_tile_f32<D, ROWS, PAIR_THREADS>(Os, dout, base, ld, q0, T, tid);
  bool uniform, uniform_next;
  int k0 = next_tile<R>(segb, 0, k_end, T, qlo, qhi, lane, uniform);
  if (k0 < k_end) {  // always: every in-range query sees its own key
    stage_tile_f32<D, R, PAIR_THREADS>(Ks, k, base, ld, k0, T, tid);
    stage_tile_f32<D, R, PAIR_THREADS>(Vs, v, base, ld, k0, T, tid);
  }
  cp_async_commit();

  // this thread's two queries, rows g and g + 8 of its group's 16; rows past T
  // are never stored
  const int row0 = q0 + 16 * qg + g, row1 = row0 + 8;
  const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;
  const float row_lse[2] = {row0 < T ? lse[row_base + row0] : 0.f,
                            row1 < T ? lse[row_base + row1] : 0.f};
  const float row_delta[2] = {row0 < T ? delta[row_base + row0] : 0.f,
                              row1 < T ? delta[row_base + row1] : 0.f};
  // the operand of this warp's score tile that the block keeps: Q or dO
  const float* a_tile = role ? Os : Qs;
  float* mine = Xs + (2 * qg + role) * XW;
  const float* theirs = Xs + (2 * qg + (role ^ 1)) * XW;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
  while (k0 < k_end) {
    const int kn = next_tile<R>(segb, k0 + R, k_end, T, qlo, qhi, lane, uniform_next);
    if (kn < k_end) {
      stage_tile_f32<D, R, PAIR_THREADS>(Ks + (stage ^ 1) * KW, k, base, ld, kn, T, tid);
      stage_tile_f32<D, R, PAIR_THREADS>(Vs + (stage ^ 1) * KW, v, base, ld, kn, T, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + stage * KW;
    const float* Vt = Vs + stage * KW;
    // the ragged edge, the tiles on the diagonal and a tile whose ids are not
    // all the query tile's single id are masked element by element
    const bool masked = !uniform || k0 + R > T || (causal && k0 + R > q0);

    // S (role 0) or dP (role 1): element (n, e) at query row e < 2 ? g :
    // g + 8, key 8 n + 2 t4 + (e & 1)
    float sc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const float* b_tile = role ? Vt : Kt;
#pragma unroll 4
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ab[4], as[4];
      load_a_split<D>(ab, as, a_tile, 16 * qg, kc, lane);
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t bb[4], bs[4];
        load_b2_split<D>(bb, bs, b_tile, 8 * n, kc, lane);
        mma_3xtf32(sc[n], ab, as, bb[0], bb[1], bs[0], bs[1]);
        mma_3xtf32(sc[n + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
      }
    }
    if (role == 0) {  // P
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = expf(sc[n][e] * scale - row_lse[r]);
          if (masked) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1);
            const int row = r == 0 ? row0 : row1;
            const bool ok = key < T && segb[key] == (r == 0 ? seg0 : seg1) &&
                            (!causal || key <= row);
            p = ok ? p : 0.f;
          }
          sc[n][e] = p;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32 + lane] = sc[n][e];
    group_sync(1 + qg, 64);

    // dS from P and dP, the same bits in both warps of the group
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float other = theirs[(4 * n + e) * 32 + lane];
        const float p = role ? other : sc[n][e];
        const float dp = role ? sc[n][e] : other;
        sc[n][e] = p * (dp - row_delta[e >> 1]) * scale;
      }
    }
    // n-tile n of dS is the A operand of the k-chunk over its 8 keys
    const float* g_tile = Kt + (D / 2) * role;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t sb[4], ss[4];
      acc_as_a(sc[n], sb, ss);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t kb[2], ks[2];
        load_bt_split<D>(kb, ks, g_tile, 8 * n, j, g, t4);
        mma_3xtf32(acc[j], sb, ss, kb[0], kb[1], ks[0], ks[1]);
      }
    }
    __syncthreads();  // every warp is done with this stage and the score tiles
    k0 = kn;
    uniform = uniform_next;
    stage ^= 1;
  }

  // element (j, e): query row e < 2 ? g : g + 8, head-dim column
  // 64 role + 8 j + 2 t4 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i == 0 ? row0 : row1;
    if (t < T) {
      float* dst = dq + base + (long)t * ld + (D / 2) * role + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernels at D 256 on Hopper's own units (flash_attention_wgmma.cuh),
// laid out as the bf16 forward at D 256: one launch a call, one block of three
// warpgroups, a producer warp whose TMA copies stream 64-row tiles into a
// two-stage ring (each stage's `full` barrier counting the bytes in, its
// `empty` barrier the 8 consumer warps out), and two consumer warpgroups
// (`setmaxnreg`: 40 registers a producer thread, 232 a consumer thread).  Each
// score tile is formed once, by one warpgroup, on wgmma m64n64k16 from shared
// memory (16 k-steps over D); what the other warpgroup needs of it crosses in
// shared memory between two named barriers.  The gradient products take their
// A operand (p or dS, rounded to bf16) in registers and read their B operand
// transposed (MN-major) from shared memory.  Every warp walks the same tiles
// (`next_tile` over the block's own segment range), so the producer and the
// consumers agree on them without passing them through shared memory; the
// ragged edge, the diagonal tile and a tile whose ids are not all the block's
// single id are masked element by element.  Rows past T arrive as TMA's zero
// fill and are never stored.  lse and delta are read from device memory (L1)
// before the score product they follow.
// ---------------------------------------------------------------------------

namespace fa_hop = flash::hopper;

constexpr int WG_ROWS = 64;              // rows of every tile, the block's own and the streamed
constexpr int WG_THREADS = 384;          // 2 consumer warpgroups + 1 producer warpgroup
constexpr uint32_t WG_BLOCK = WG_ROWS * 128;  // bytes of a tile's 64-column block
// named barriers between the two consumer warpgroups (0 is __syncthreads)
constexpr int XCHG_A = 1, XCHG_B = 2;

// acc = A B^T over D (16 k-steps of wgmma m64n64k16), A and B 64-row tiles
// of D / 64 swizzled column blocks at shared addresses `a` and `b`; committed,
// not waited for
template <int D>
__device__ __forceinline__ void score_product(float (&acc)[32], uint32_t a, uint32_t b) {
  using namespace fa_hop;
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    // k-step kc: column block kc / 4, 32 bytes a step within it
    const uint32_t at = (kc >> 2) * WG_BLOCK + (kc & 3) * 32;
    wgmma_m64n64k16_ss(acc, desc_sw128(a + at, 16, 1024), desc_sw128(b + at, 16, 1024), kc > 0);
  }
  wgmma_commit();
}

template <int D>
constexpr size_t dkv_wgmma_smem_bytes() {
  // K, V; Q and dO x 2 stages; the P^T exchange (64 x 64 fp32); 5 barriers;
  // 1024 bytes to align the tiles to the swizzle's period: 214,056 B
  return 2 * (size_t)D * WG_ROWS * 6 + 4 * WG_ROWS * WG_ROWS + 5 * 8 + 1024;
}

template <int D>
constexpr size_t dq_wgmma_smem_bytes() {
  // Q, dO; K and V x 2 stages; the P exchange (fp32) and the dS exchange
  // (bf16 A fragments); 5 barriers; 1024 to align: 222,248 B
  return 2 * (size_t)D * WG_ROWS * 6 + 6 * WG_ROWS * WG_ROWS + 5 * 8 + 1024;
}

// dK/dV at D 256.  One block per 64-key tile; K and V are copied once and
// stay, the visible 64-query tiles of Q and dO (from the diagonal with
// `causal`) stream through the ring.  Warpgroup 0 owns dV, warpgroup 1 dK,
// each a 64 x 256 fp32 accumulator (128 registers a thread, the whole row):
//   wg 0:  S^T = K Q^T;  P^T = exp(S^T * scale - lse), 0 where masked
//          P^T (fp32) -> shared memory;  dV += bf16(P^T) dO   (m64n256k16)
//   wg 1:  dP^T = V dO^T;  P^T <- shared memory
//          dS^T = P^T o (dP^T - delta) * scale   (from the unrounded P^T)
//          dK += bf16(dS^T) Q                     (m64n256k16)
// so the four products are each done once.  Thread i of one warpgroup holds
// the score elements that thread i of the other holds, so the exchange is a
// [32 values][128 threads] array: barrier A says a tile's P^T is written,
// barrier B that it has been read (before the next tile's is written).
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap omap, const int* __restrict__ seg,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int T,
                           int H, float scale, int causal) {
  using namespace fa_hop;
  using fa_mma::LOG2E;
  static_assert(D == 256, "the wgmma form is built for D 256");
  constexpr uint32_t TILE = (D / 64) * WG_BLOCK;  // bytes of a 64-row tile

  extern __shared__ uint8_t smem_dkv_wg[];
  const uint32_t base_u32 = smem_u32(smem_dkv_wg);
  const uint32_t sK = (base_u32 + 1023u) & ~1023u;
  const uint32_t sV = sK + TILE;
  const uint32_t sQ = sV + TILE;      // [2 stages]
  const uint32_t sO = sQ + 2 * TILE;  // dO, [2 stages]
  const uint32_t sX = sO + 2 * TILE;  // P^T: [8 float4][128 threads]
  const uint32_t kv_full = sX + 4 * WG_ROWS * WG_ROWS;  // then full[2], empty[2]
  const uint32_t full0 = kv_full + 8, empty0 = kv_full + 24;
  float4* xchg = reinterpret_cast<float4*>(smem_dkv_wg + (sX - base_u32));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * WG_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int* segb = seg + (long)b * T;

  int klo, khi;
  fa_mma::segment_range(segb, k0, T, lane, klo, khi);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // causal: the query tiles before this key tile's own row see none of its keys
  bool uniform, uniform_next;
  int q0 = fa_mma::next_tile(segb, causal ? k0 : 0, T, T, klo, khi, lane, uniform);

  if (warp >= 8) {  // ---- the producer warpgroup: one warp copies ----
    setmaxnreg_dec<40>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * TILE);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sK + c * WG_BLOCK, &kmap, kv_full, 64 * c, h, k0, b);
        tma_load_4d(sV + c * WG_BLOCK, &vmap, kv_full, 64 * c, h, k0, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    while (q0 < T) {
      if (lane == 0) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the round before freed this stage
        const uint32_t full = full0 + 8 * stage;
        mbar_arrive_expect_tx(full, 2 * TILE);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sQ + stage * TILE + c * WG_BLOCK, &qmap, full, 64 * c, h, q0, b);
          tma_load_4d(sO + stage * TILE + c * WG_BLOCK, &omap, full, 64 * c, h, q0, b);
        }
      }
      q0 = fa_mma::next_tile(segb, q0 + WG_ROWS, T, T, klo, khi, lane, uniform_next);
      if (++stage == 2) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {  // ---- the consumer warpgroups ----
    setmaxnreg_inc<232>();
    const bool is_dk = warp >= 4;
    const int wt = tid & 127, g = lane >> 2, t4 = lane & 3;
    // this thread's two keys, rows g and g + 8 of its warp's 16
    const int key0 = k0 + 16 * (warp & 3) + g, key1 = key0 + 8;
    const int seg0 = key0 < T ? segb[key0] : -1, seg1 = key1 < T ? segb[key1] : -1;
    const float* rows = (is_dk ? delta : lse) + ((long)b * H + h) * T;
    const float scale_log2 = scale * LOG2E;

    // dV (wg 0) or dK (wg 1): element i at key row (i & 2) ? key1 : key0,
    // column 8 (i / 4) + 2 t4 + (i & 1)
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    bool first = true;
    while (q0 < T) {
      const int qn = fa_mma::next_tile(segb, q0 + WG_ROWS, T, T, klo, khi, lane, uniform_next);
      // lse * log2 e (wg 0) or delta (wg 1) of this thread's 16 query
      // columns, 8 j + 2 t4 + c; 0 past T, where p is masked to 0
      float rv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int query = q0 + 8 * (j >> 1) + 2 * t4 + (j & 1);
        const float x = query < T ? rows[query] : 0.f;
        rv[j] = is_dk ? x : x * LOG2E;
      }
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t qt = sQ + stage * TILE, ot = sO + stage * TILE;
      // element i of s: key row (i & 2) ? key1 : key0, query column
      // 8 (i / 4) + 2 t4 + (i & 1) of the tile
      float s[32];
      score_product<D>(s, is_dk ? sV : sK, is_dk ? ot : qt);  // dP^T or S^T
      wgmma_wait<0>();
      fence_operands(s);

      if (!is_dk) {
        // the ragged edge, the diagonal tile (q0 == k0) and a tile whose ids
        // are not all the key tile's single id are masked element by element
        const bool masked = !uniform || q0 + WG_ROWS > T || (causal && q0 < k0 + WG_ROWS);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = 2 * (i >> 2) + (i & 1);
          float p = exp2f(fmaf(s[i], scale_log2, -rv[j]));
          if (masked) {
            const int query = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
            const int key = (i & 2) ? key1 : key0;
            const bool ok = query < T && segb[query] == ((i & 2) ? seg1 : seg0) &&
                            (!causal || key <= query);
            p = ok ? p : 0.f;
          }
          s[i] = p;
        }
        if (!first) group_sync(XCHG_B, 256);  // wg 1 has read the last tile's P^T
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xchg[128 * i + wt] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
        group_arrive(XCHG_A, 256);
      } else {
        group_sync(XCHG_A, 256);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 p = xchg[128 * i + wt];
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 4 * i + e;
            // dS^T, from the unrounded P^T
            s[n] = pv[e] * (s[n] - rv[2 * (n >> 2) + (n & 1)]) * scale;
          }
        }
        if (qn < T) group_arrive(XCHG_B, 256);  // wg 0 may write the next tile's
      }

      // dV += bf16(P^T) dO  or  dK += bf16(dS^T) Q, the B tile read transposed
      uint32_t pa[4][4];
      score_as_a(s, pa);
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_operands(pa[kk]);
      wgmma_fence();
      const uint32_t grad_b = is_dk ? qt : ot;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16_rs_mn(acc, pa[kk], desc_sw128(grad_b + kk * 16 * 128, WG_BLOCK, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // this warp is done with the stage
      q0 = qn;
      uniform = uniform_next;
      first = false;
      if (++stage == 2) {
        stage = 0;
        phase ^= 1;
      }
    }

    __nv_bfloat16* out = is_dk ? dk : dv;
    const long ld = (long)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r == 0 ? key0 : key1;
      if (t < T) {
        __nv_bfloat16* dst = out + ((long)b * T + t) * ld + (long)h * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dQ at D 256.  One block per 64-query tile (handed out longest first with
// `causal`); Q and dO are copied once and stay, the visible 64-key tiles of K
// and V (up to the diagonal with `causal`) stream through the ring.  Each
// warpgroup owns 128 columns of dQ (64 registers a thread):
//   wg 0:  S = Q K^T;  P = exp(S * scale - lse), 0 where masked;  P -> wg 1
//   wg 1:  dP = dO V^T;  dS = P o (dP - delta) * scale (from the unrounded P),
//          rounded to bf16 as A fragments -> wg 0
//   both:  dQ[:, 128 wg ..] += bf16(dS) K[:, 128 wg ..]   (m64n128k16)
// so S and dP are each formed once and both halves of dQ take the same dS,
// bit for bit.  Barrier A says a tile's P is written, barrier B that its dS
// is; each warpgroup's wait on the other's next hand-over also orders its own
// reads of this one before the other overwrites it.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap, const int* __restrict__ seg,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int T, int H, float scale, int causal) {
  using namespace fa_hop;
  using fa_mma::LOG2E;
  static_assert(D == 256, "the wgmma form is built for D 256");
  constexpr uint32_t TILE = (D / 64) * WG_BLOCK;

  extern __shared__ uint8_t smem_dq_wg[];
  const uint32_t base_u32 = smem_u32(smem_dq_wg);
  const uint32_t sQ = (base_u32 + 1023u) & ~1023u;
  const uint32_t sO = sQ + TILE;      // dO
  const uint32_t sK = sO + TILE;      // [2 stages]
  const uint32_t sV = sK + 2 * TILE;  // [2 stages]
  const uint32_t sP = sV + 2 * TILE;  // P: [8 float4][128 threads]
  const uint32_t sS = sP + 4 * WG_ROWS * WG_ROWS;  // dS: [4 uint4][128 threads]
  const uint32_t q_full = sS + 2 * WG_ROWS * WG_ROWS;  // then full[2], empty[2]
  const uint32_t full0 = q_full + 8, empty0 = q_full + 24;
  float4* xp = reinterpret_cast<float4*>(smem_dq_wg + (sP - base_u32));
  uint4* xs = reinterpret_cast<uint4*>(smem_dq_wg + (sS - base_u32));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * WG_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int* segb = seg + (long)b * T;

  int qlo, qhi;
  fa_mma::segment_range(segb, q0, T, lane, qlo, qhi);
  // causal: the tiles past the diagonal tile (k0 == q0) hold no visible key
  const int k_end = causal ? min(T, q0 + WG_ROWS) : T;

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
      mbar_arrive_expect_tx(q_full, 2 * TILE);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sQ + c * WG_BLOCK, &qmap, q_full, 64 * c, h, q0, b);
        tma_load_4d(sO + c * WG_BLOCK, &omap, q_full, 64 * c, h, q0, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    while (k0 < k_end) {  // always entered: every in-range query sees its own key
      if (lane == 0) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the round before freed this stage
        const uint32_t full = full0 + 8 * stage;
        mbar_arrive_expect_tx(full, 2 * TILE);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + stage * TILE + c * WG_BLOCK, &kmap, full, 64 * c, h, k0, b);
          tma_load_4d(sV + stage * TILE + c * WG_BLOCK, &vmap, full, 64 * c, h, k0, b);
        }
      }
      k0 = fa_mma::next_tile(segb, k0 + WG_ROWS, k_end, T, qlo, qhi, lane, uniform_next);
      if (++stage == 2) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {  // ---- the consumer warpgroups ----
    setmaxnreg_inc<232>();
    const int wg = warp >> 2, wt = tid & 127, g = lane >> 2, t4 = lane & 3;
    // this thread's two queries, rows g and g + 8 of its warp's 16; rows past
    // T are never stored
    const int row0 = q0 + 16 * (warp & 3) + g, row1 = row0 + 8;
    const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;
    const long row_base = ((long)b * H + h) * T;
    const float lse_l2[2] = {row0 < T ? lse[row_base + row0] * LOG2E : 0.f,
                             row1 < T ? lse[row_base + row1] * LOG2E : 0.f};
    const float row_delta[2] = {row0 < T ? delta[row_base + row0] : 0.f,
                                row1 < T ? delta[row_base + row1] : 0.f};
    const float scale_log2 = scale * LOG2E;

    // dQ: element i at row (i & 2) ? row1 : row0, column 128 wg + 8 (i / 4) + 2 t4 + (i & 1)
    float acc[D / 4];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    while (k0 < k_end) {
      const int kn =
          fa_mma::next_tile(segb, k0 + WG_ROWS, k_end, T, qlo, qhi, lane, uniform_next);
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t kt = sK + stage * TILE, vt = sV + stage * TILE;
      // element i of s: query row (i & 2) ? row1 : row0, key 8 (i / 4) + 2 t4 + (i & 1)
      float s[32];
      score_product<D>(s, wg ? sO : sQ, wg ? vt : kt);  // dP or S
      wgmma_wait<0>();
      fence_operands(s);

      uint32_t sa[4][4];  // bf16(dS), the A fragments of dQ += dS K
      if (wg == 0) {
        // the ragged edge, the diagonal tile and a tile whose ids are not all
        // the query tile's single id are masked element by element
        const bool masked = !uniform || k0 + WG_ROWS > T || (causal && k0 + WG_ROWS > q0);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          float p = exp2f(fmaf(s[i], scale_log2, -lse_l2[r]));
          if (masked) {
            const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
            const bool ok = key < T && segb[key] == (r ? seg1 : seg0) &&
                            (!causal || key <= (r ? row1 : row0));
            p = ok ? p : 0.f;
          }
          s[i] = p;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xp[128 * i + wt] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
        group_arrive(XCHG_A, 256);
        group_sync(XCHG_B, 256);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint4 x = xs[128 * kk + wt];
          sa[kk][0] = x.x;
          sa[kk][1] = x.y;
          sa[kk][2] = x.z;
          sa[kk][3] = x.w;
        }
      } else {
        group_sync(XCHG_A, 256);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 p = xp[128 * i + wt];
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 4 * i + e;
            s[n] = pv[e] * (s[n] - row_delta[(n >> 1) & 1]) * scale;  // dS, from the unrounded p
          }
        }
        score_as_a(s, sa);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          xs[128 * kk + wt] = make_uint4(sa[kk][0], sa[kk][1], sa[kk][2], sa[kk][3]);
        group_arrive(XCHG_B, 256);
      }

      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_operands(sa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_rs_mn(
            acc, sa[kk], desc_sw128(kt + 2 * wg * WG_BLOCK + kk * 16 * 128, WG_BLOCK, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // this warp is done with the stage
      k0 = kn;
      uniform = uniform_next;
      if (++stage == 2) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long ld = (long)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r == 0 ? row0 : row1;
      if (t < T) {
        __nv_bfloat16* dst = dq + ((long)b * T + t) * ld + (long)h * D + (D / 2) * wg + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernels at D 128 on Hopper's own units (flash_attention_wgmma.cuh),
// each warpgroup owning its rows whole.  At D 128 a thread can hold a 64-row
// warpgroup's share of two 64 x 128 fp32 accumulators (dK and dV: 64 + 64
// registers), so no tile crosses between the warpgroups, unlike at D 256:
// each consumer warpgroup forms its own score tiles S and dP (wgmma m64n64k16
// from shared memory, 8 k-steps over D), its own P and dS in registers, and
// its own gradient products (m64n128k16, the bf16 P or dS as the register A
// operand, the B tile read transposed), so one warpgroup's exp runs under the
// other's products with no barrier between them.  A block owns 128 rows (two
// warpgroups of 64) and streams 64-row tiles of the other side, so every
// streamed tile is read by 128 rows: half the L2 reads of a 64-row block.
// One launch a call, one block of three warpgroups (a producer warp, two
// consumer warpgroups; `setmaxnreg` 24 / 240: 128 x 24 + 256 x 240 = 64,512
// of the SM's 65,536).  The producer TMA-copies the block's own 128-row tiles
// once and the streamed tiles into a ring of OWN_STAGES stages (each stage's
// `full` barrier counting the bytes in and its `empty` barrier the 8 consumer
// warps out); every warp walks the same tiles (`next_tile` over the 128-row
// block's segment range, so a skipped tile holds no row that any of the
// block's rows sees).  With `causal` a warpgroup skips the products of a
// tile wholly on the far side of its own diagonal, still releasing the stage,
// and only its diagonal, ragged and mixed-segment tiles are masked element by
// element.  Rows past T arrive as TMA's zero fill and are never stored.  The
// fp32 sums, the roundings and the fixed order per output element are those
// of the kernels above: no atomics, two runs give the same bits.
// ---------------------------------------------------------------------------

constexpr int OWN_ROWS = 128;   // rows of a block's own tile: two warpgroups of 64
constexpr int OWN_STAGES = 2;   // stages of the ring of streamed 64-row tiles
constexpr uint32_t OWN_BLOCK = OWN_ROWS * 128;  // bytes of an own tile's 64-column block

template <int D>
constexpr size_t dkv_own_smem_bytes() {
  // K, V (128 rows); Q and dO x stages (64 rows); each stage's lse and delta
  // rows (fp32); 1 + 2 x stages barriers; 1024 bytes to align: 133,160 B
  return 2 * (size_t)D * (2 * OWN_ROWS + 2 * WG_ROWS * OWN_STAGES) +
         2 * 4 * WG_ROWS * OWN_STAGES + (1 + 2 * OWN_STAGES) * 8 + 1024;
}

template <int D>
constexpr size_t dq_own_smem_bytes() {
  // Q, dO (128 rows); K and V x stages (64 rows); barriers; align: 132,136 B
  return 2 * (size_t)D * (2 * OWN_ROWS + 2 * WG_ROWS * OWN_STAGES) + (1 + 2 * OWN_STAGES) * 8 +
         1024;
}

// S (or S^T) into `s` and dP (or dP^T) into `dp`, each A B^T over D with A
// this warpgroup's 64 rows of a 128-row tile and B a streamed 64-row tile
// (K-major, swizzled): two commit groups, S first, neither waited for
template <int D>
__device__ __forceinline__ void own_score_products(float (&s)[32], float (&dp)[32], uint32_t sa,
                                                   uint32_t sb, uint32_t da, uint32_t db) {
  using namespace fa_hop;
  fence_operands(s);
  fence_operands(dp);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    // k-step kc: column block kc / 4, 32 bytes a step within it
    const uint32_t a = (kc >> 2) * OWN_BLOCK + (kc & 3) * 32;
    const uint32_t b = (kc >> 2) * WG_BLOCK + (kc & 3) * 32;
    wgmma_m64n64k16_ss(s, desc_sw128(sa + a, 16, 1024), desc_sw128(sb + b, 16, 1024), kc > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint32_t a = (kc >> 2) * OWN_BLOCK + (kc & 3) * 32;
    const uint32_t b = (kc >> 2) * WG_BLOCK + (kc & 3) * 32;
    wgmma_m64n64k16_ss(dp, desc_sw128(da + a, 16, 1024), desc_sw128(db + b, 16, 1024), kc > 0);
  }
  wgmma_commit();
}

// dK/dV at D 128.  One block per 128-key tile; K and V are copied once and
// stay, the visible 64-query tiles of Q and dO (from the block's diagonal
// with `causal`) stream through the ring with their lse (times log2 e) and
// delta rows, which the producer warp's lanes store into the stage beside
// them (0 past T) before they arrive on its `full` barrier.  Warpgroup w owns
// keys 64 w .. 64 w + 63 of the tile, their dK and dV whole:
//   S^T = K Q^T,  dP^T = V dO^T                      (m64n64k16, 8 k-steps)
//   P^T = exp(S^T * scale - lse), 0 where masked
//   dS^T = P^T o (dP^T - delta) * scale              (from the unrounded P^T)
//   dV += bf16(P^T) dO,  dK += bf16(dS^T) Q          (m64n128k16, 4 k-steps)
// P^T is formed while dP^T's product is still running.
template <>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wgmma_kernel<128>(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap omap,
                                const int* __restrict__ seg, const float* __restrict__ lse,
                                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int T, int H, float scale,
                                int causal) {
  using namespace fa_hop;
  using fa_mma::LOG2E;
  constexpr int D = 128;
  constexpr uint32_t OWN_TILE = (D / 64) * OWN_BLOCK;  // bytes of a 128-row tile
  constexpr uint32_t TILE = (D / 64) * WG_BLOCK;       // bytes of a streamed 64-row tile

  extern __shared__ uint8_t smem_dkv_own[];
  const uint32_t base_u32 = smem_u32(smem_dkv_own);
  const uint32_t sK = (base_u32 + 1023u) & ~1023u;
  const uint32_t sV = sK + OWN_TILE;
  const uint32_t sQ = sV + OWN_TILE;              // [stages]
  const uint32_t sO = sQ + OWN_STAGES * TILE;     // dO, [stages]
  const uint32_t sR = sO + OWN_STAGES * TILE;     // [stages][lse * log2 e, delta][64] fp32
  const uint32_t kv_full = sR + OWN_STAGES * 2 * WG_ROWS * 4;  // then full[stages], empty[stages]
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * OWN_STAGES;
  float* rows_s = reinterpret_cast<float*>(smem_dkv_own + (sR - base_u32));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * OWN_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int* segb = seg + (long)b * T;

  int klo, khi;
  fa_mma::segment_range<OWN_ROWS>(segb, k0, T, lane, klo, khi);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < OWN_STAGES; ++st) {
      mbar_init(full0 + 8 * st, 32);   // every lane of the producer warp
      mbar_init(empty0 + 8 * st, 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // causal: the query tiles before this key tile's own row see none of its keys
  bool uniform, uniform_next;
  int q0 = fa_mma::next_tile(segb, causal ? k0 : 0, T, T, klo, khi, lane, uniform);

  if (warp >= 8) {  // ---- the producer warpgroup: one warp copies ----
    setmaxnreg_dec<24>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * OWN_TILE);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sK + c * OWN_BLOCK, &kmap, kv_full, 64 * c, h, k0, b);
        tma_load_4d(sV + c * OWN_BLOCK, &vmap, kv_full, 64 * c, h, k0, b);
      }
    }
    const long row_base = ((long)b * H + h) * T;
    int stage = 0;
    uint32_t phase = 0;
    while (q0 < T) {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the round before freed this stage
      float* rows_t = rows_s + stage * 2 * WG_ROWS;
      for (int i = lane; i < WG_ROWS; i += 32) {
        const int query = q0 + i;
        rows_t[i] = query < T ? lse[row_base + query] * LOG2E : 0.f;
        rows_t[WG_ROWS + i] = query < T ? delta[row_base + query] : 0.f;
      }
      const uint32_t full = full0 + 8 * stage;
      if (lane == 0) {
        mbar_arrive_expect_tx(full, 2 * TILE);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sQ + stage * TILE + c * WG_BLOCK, &qmap, full, 64 * c, h, q0, b);
          tma_load_4d(sO + stage * TILE + c * WG_BLOCK, &omap, full, 64 * c, h, q0, b);
        }
      } else {
        mbar_arrive(full);  // releases this lane's lse and delta stores
      }
      q0 = fa_mma::next_tile(segb, q0 + WG_ROWS, T, T, klo, khi, lane, uniform_next);
      if (++stage == OWN_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {  // ---- the consumer warpgroups ----
    setmaxnreg_inc<240>();
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    const int wk0 = k0 + 64 * wg;  // this warpgroup's first key
    // this thread's two keys, rows g and g + 8 of its warp's 16
    const int key0 = wk0 + 16 * (warp & 3) + g, key1 = key0 + 8;
    const int seg0 = key0 < T ? segb[key0] : -1, seg1 = key1 < T ? segb[key1] : -1;
    const float scale_log2 = scale * LOG2E;
    const uint32_t ka = sK + wg * WG_BLOCK, va = sV + wg * WG_BLOCK;  // this warpgroup's rows

    // element i at key row (i & 2) ? key1 : key0, column 8 (i / 4) + 2 t4 + (i & 1)
    float acc_dv[D / 2], acc_dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dv[i] = acc_dk[i] = 0.f;

    mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    while (q0 < T) {
      const int qn = fa_mma::next_tile(segb, q0 + WG_ROWS, T, T, klo, khi, lane, uniform_next);
      mbar_wait(full0 + 8 * stage, phase);
      if (!causal || q0 + WG_ROWS > wk0) {  // else every query of the tile precedes these keys
        const uint32_t qt = sQ + stage * TILE, ot = sO + stage * TILE;
        const float* lse_t = rows_s + stage * 2 * WG_ROWS;
        const float* delta_t = lse_t + WG_ROWS;
        // element i of s and dp: key row (i & 2) ? key1 : key0, query column
        // 8 (i / 4) + 2 t4 + (i & 1) of the tile
        float s[32], dp[32];
        own_score_products<D>(s, dp, ka, qt, va, ot);  // S^T, dP^T
        wgmma_wait<1>();
        fence_operands(s);
        // the ragged edge, this warpgroup's diagonal tile (q0 == wk0) and a
        // tile whose ids are not all the key tile's single id are masked
        // element by element
        const bool masked = !uniform || q0 + WG_ROWS > T || (causal && q0 < wk0 + WG_ROWS);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 row = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = exp2f(fmaf(s[i], scale_log2, -((e & 1) ? row.y : row.x)));
            if (masked) {
              const int query = q0 + 8 * j + 2 * t4 + (e & 1);
              const int key = (e & 2) ? key1 : key0;
              const bool ok = query < T && segb[query] == ((e & 2) ? seg1 : seg0) &&
                              (!causal || key <= query);
              p = ok ? p : 0.f;
            }
            s[i] = p;
          }
        }
        wgmma_wait<0>();
        fence_operands(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 row = *reinterpret_cast<const float2*>(delta_t + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            // dS^T, from the unrounded P^T
            dp[i] = s[i] * (dp[i] - ((e & 1) ? row.y : row.x)) * scale;
          }
        }
        // dV += bf16(P^T) dO,  dK += bf16(dS^T) Q, the B tiles read transposed
        uint32_t pa[4][4], sa[4][4];
        score_as_a(s, pa);
        score_as_a(dp, sa);
        fence_operands(acc_dv);
        fence_operands(acc_dk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_operands(pa[kk]);
          fence_operands(sa[kk]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs_mn(acc_dv, pa[kk], desc_sw128(ot + kk * 16 * 128, WG_BLOCK, 1024));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs_mn(acc_dk, sa[kk], desc_sw128(qt + kk * 16 * 128, WG_BLOCK, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc_dv);
        fence_operands(acc_dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // this warp is done with the stage
      q0 = qn;
      uniform = uniform_next;
      if (++stage == OWN_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long ld = (long)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r == 0 ? key0 : key1;
      if (t < T) {
        const long at = ((long)b * T + t) * ld + (long)h * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
              __floats2bfloat162_rn(acc_dk[4 * j + 2 * r], acc_dk[4 * j + 2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
              __floats2bfloat162_rn(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// dQ at D 128.  One block per 128-query tile (handed out longest first with
// `causal`); Q and dO are copied once and stay, the visible 64-key tiles of K
// and V (up to the block's diagonal with `causal`) stream through the ring.
// Warpgroup w owns queries 64 w .. 64 w + 63 of the tile, their dQ whole (64
// registers a thread), and each thread keeps its two rows' lse and delta:
//   S = Q K^T,  dP = dO V^T                          (m64n64k16, 8 k-steps)
//   P = exp(S * scale - lse), 0 where masked
//   dS = P o (dP - delta) * scale                    (from the unrounded P)
//   dQ += bf16(dS) K                                 (m64n128k16, 4 k-steps)
template <>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel<128>(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap omap,
                               const int* __restrict__ seg, const float* __restrict__ lse,
                               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                               int T, int H, float scale, int causal) {
  using namespace fa_hop;
  using fa_mma::LOG2E;
  constexpr int D = 128;
  constexpr uint32_t OWN_TILE = (D / 64) * OWN_BLOCK;
  constexpr uint32_t TILE = (D / 64) * WG_BLOCK;

  extern __shared__ uint8_t smem_dq_own[];
  const uint32_t sQ = (smem_u32(smem_dq_own) + 1023u) & ~1023u;
  const uint32_t sO = sQ + OWN_TILE;              // dO
  const uint32_t sK = sO + OWN_TILE;              // [stages]
  const uint32_t sV = sK + OWN_STAGES * TILE;     // [stages]
  const uint32_t q_full = sV + OWN_STAGES * TILE;  // then full[stages], empty[stages]
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * OWN_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * OWN_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int* segb = seg + (long)b * T;

  int qlo, qhi;
  fa_mma::segment_range<OWN_ROWS>(segb, q0, T, lane, qlo, qhi);
  // causal: the tiles past the block's last row hold no visible key
  const int k_end = causal ? min(T, q0 + OWN_ROWS) : T;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < OWN_STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  bool uniform, uniform_next;
  int k0 = fa_mma::next_tile(segb, 0, k_end, T, qlo, qhi, lane, uniform);

  if (warp >= 8) {  // ---- the producer warpgroup: one warp copies ----
    setmaxnreg_dec<24>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * OWN_TILE);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sQ + c * OWN_BLOCK, &qmap, q_full, 64 * c, h, q0, b);
        tma_load_4d(sO + c * OWN_BLOCK, &omap, q_full, 64 * c, h, q0, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    while (k0 < k_end) {  // always entered: every in-range query sees its own key
      if (lane == 0) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the round before freed this stage
        const uint32_t full = full0 + 8 * stage;
        mbar_arrive_expect_tx(full, 2 * TILE);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + stage * TILE + c * WG_BLOCK, &kmap, full, 64 * c, h, k0, b);
          tma_load_4d(sV + stage * TILE + c * WG_BLOCK, &vmap, full, 64 * c, h, k0, b);
        }
      }
      k0 = fa_mma::next_tile(segb, k0 + WG_ROWS, k_end, T, qlo, qhi, lane, uniform_next);
      if (++stage == OWN_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {  // ---- the consumer warpgroups ----
    setmaxnreg_inc<240>();
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    const int wq0 = q0 + 64 * wg;  // this warpgroup's first query
    // this thread's two queries, rows g and g + 8 of its warp's 16; rows past
    // T are never stored
    const int row0 = wq0 + 16 * (warp & 3) + g, row1 = row0 + 8;
    const int seg0 = row0 < T ? segb[row0] : -1, seg1 = row1 < T ? segb[row1] : -1;
    const long row_base = ((long)b * H + h) * T;
    const float lse_l2[2] = {row0 < T ? lse[row_base + row0] * LOG2E : 0.f,
                             row1 < T ? lse[row_base + row1] * LOG2E : 0.f};
    const float row_delta[2] = {row0 < T ? delta[row_base + row0] : 0.f,
                                row1 < T ? delta[row_base + row1] : 0.f};
    const float scale_log2 = scale * LOG2E;
    const uint32_t qa = sQ + wg * WG_BLOCK, oa = sO + wg * WG_BLOCK;  // this warpgroup's rows

    // dQ: element i at row (i & 2) ? row1 : row0, column 8 (i / 4) + 2 t4 + (i & 1)
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    while (k0 < k_end) {
      const int kn =
          fa_mma::next_tile(segb, k0 + WG_ROWS, k_end, T, qlo, qhi, lane, uniform_next);
      mbar_wait(full0 + 8 * stage, phase);
      if (!causal || k0 < wq0 + WG_ROWS) {  // else every key of the tile follows these queries
        const uint32_t kt = sK + stage * TILE, vt = sV + stage * TILE;
        // element i of s and dp: query row (i & 2) ? row1 : row0, key
        // 8 (i / 4) + 2 t4 + (i & 1) of the tile
        float s[32], dp[32];
        own_score_products<D>(s, dp, qa, kt, oa, vt);  // S, dP
        wgmma_wait<1>();
        fence_operands(s);
        // the ragged edge, this warpgroup's diagonal tile and a tile whose
        // ids are not all the query tile's single id are masked element by
        // element
        const bool masked = !uniform || k0 + WG_ROWS > T || (causal && k0 + WG_ROWS > wq0);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          float p = exp2f(fmaf(s[i], scale_log2, -lse_l2[r]));
          if (masked) {
            const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
            const bool ok = key < T && segb[key] == (r ? seg1 : seg0) &&
                            (!causal || key <= (r ? row1 : row0));
            p = ok ? p : 0.f;
          }
          s[i] = p;
        }
        wgmma_wait<0>();
        fence_operands(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i)  // dS, from the unrounded p
          dp[i] = s[i] * (dp[i] - row_delta[(i >> 1) & 1]) * scale;
        // dQ += bf16(dS) K, K read transposed
        uint32_t sa[4][4];
        score_as_a(dp, sa);
        fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_operands(sa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs_mn(acc, sa[kk], desc_sw128(kt + kk * 16 * 128, WG_BLOCK, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // this warp is done with the stage
      k0 = kn;
      uniform = uniform_next;
      if (++stage == OWN_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long ld = (long)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r == 0 ? row0 : row1;
      if (t < T) {
        __nv_bfloat16* dst = dq + ((long)b * T + t) * ld + (long)h * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// what both kernels read, as the C interface hands it over
struct Inputs {
  const void *q, *k, *v;
  const int* seg;
  const float *lse, *delta;
  const void* dout;
  int B, T, H;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T>
const T* in_ptr(const void* p) {
  return static_cast<const T*>(p);
}

using fa_mma::bf16;

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// one block per (`rows`-row tile, head, batch row)
inline dim3 grid_of(const Inputs& in, int rows = fa_mma::ROWS) {
  return dim3((in.T + rows - 1) / rows, in.H, in.B);
}

// bf16 at D 128 and 256: a wgmma kernel, one block of WG_THREADS per
// (`rows`-row tile, head, batch row), its four TMA maps (q, k, v, dO) built
// here with boxes of `qo_rows` rows for q and dO and `kv_rows` for k and v
template <int D, typename Kernel, typename... Out>
cudaError_t launch_wgmma(Kernel kernel, size_t smem, const Inputs& in, int rows, int qo_rows,
                         int kv_rows, Out*... out) {
  CUtensorMap maps[4];
  const void* xs[4] = {in.q, in.k, in.v, in.dout};
  const int boxes[4] = {qo_rows, kv_rows, kv_rows, qo_rows};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = fa_hop::bf16_rows_map(&maps[i], xs[i], in.B, in.T, in.H, D, boxes[i]);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(in, rows), WG_THREADS, smem, in.stream>>>(
      maps[0], maps[1], maps[2], maps[3], in.seg, in.lse, in.delta, static_cast<bf16*>(out)...,
      in.T, in.H, in.scale, in.causal);
  return cudaGetLastError();
}

// fp32 (3xTF32): one block of `threads` per (`rows`-row tile, head, batch row)
template <typename Kernel, typename... Out>
cudaError_t launch_f32(Kernel kernel, size_t smem, const Inputs& in, int rows, int threads,
                       Out*... out) {
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(in, rows), threads, smem, in.stream>>>(
      in_ptr<float>(in.q), in_ptr<float>(in.k), in_ptr<float>(in.v), in.seg, in.lse, in.delta,
      in_ptr<float>(in.dout), static_cast<float*>(out)..., in.T, in.H, in.scale, in.causal);
  return cudaGetLastError();
}

// One launch a call.  `Elem` is float (the 3xTF32 kernels) or bf16.  bf16: the
// mma.sync kernel up to D 64, the wgmma kernel at D 128 (a block per 128-key
// tile, 64-query tiles streamed) and 256 (per 64-key tile); fp32: one block
// of 4 warps per 64-key tile up to D 64, the pair kernel (8 warps per 64-key
// tile) at D 128, the split kernel (8 warps per 32-key tile) at D 256
template <int D, typename Elem>
cudaError_t launch_dkv(const Inputs& in, void* dk, void* dv) {
  if constexpr (sizeof(Elem) == 2 && D == 128) {
    return launch_wgmma<D>(flash_bwd_dkv_wgmma_kernel<D>, dkv_own_smem_bytes<D>(), in, OWN_ROWS,
                           WG_ROWS, OWN_ROWS, dk, dv);
  } else if constexpr (sizeof(Elem) == 2 && D > 128) {
    return launch_wgmma<D>(flash_bwd_dkv_wgmma_kernel<D>, dkv_wgmma_smem_bytes<D>(), in, WG_ROWS,
                           WG_ROWS, WG_ROWS, dk, dv);
  } else if constexpr (sizeof(Elem) == 2) {
    constexpr size_t smem = dkv_mma_smem_bytes<D>();
    const auto kernel = flash_bwd_dkv_mma_kernel<D>;
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(in), fa_mma::THREADS, smem, in.stream>>>(
        in_ptr<bf16>(in.q), in_ptr<bf16>(in.k), in_ptr<bf16>(in.v), in.seg, in.lse, in.delta,
        in_ptr<bf16>(in.dout), static_cast<bf16*>(dk), static_cast<bf16*>(dv), in.T, in.H,
        in.scale, in.causal);
    return cudaGetLastError();
  } else if constexpr (D <= 64) {
    return launch_f32(flash_bwd_dkv_tf32_kernel<D>, dkv_tf32_smem_bytes<D>(), in, fa_mma::ROWS,
                      fa_mma::THREADS, dk, dv);
  } else if constexpr (D == 128) {
    return launch_f32(flash_bwd_dkv_tf32_pair_kernel<D>, dkv_pair_smem_bytes<D>(), in,
                      fa_mma::ROWS, PAIR_THREADS, dk, dv);
  } else {
    return launch_f32(flash_bwd_dkv_tf32_split_kernel<D>, dkv_split_smem_bytes<D>(), in,
                      SPLIT_KEYS, SPLIT_THREADS, dk, dv);
  }
}

// One launch a call.  bf16: the mma.sync kernel up to D 64 (per 64-query
// tile), the wgmma kernel at D 128 (per 128-query tile, 64-key tiles
// streamed) and 256 (per 64-query tile); fp32: 4 warps per 64-query tile up
// to D 64, the pair kernel (8 warps, 32-key tiles streamed) at D 128, the
// split kernel (8 warps) at D 256
template <int D, typename Elem>
cudaError_t launch_dq(const Inputs& in, void* dq) {
  if constexpr (sizeof(Elem) == 2 && D == 128) {
    return launch_wgmma<D>(flash_bwd_dq_wgmma_kernel<D>, dq_own_smem_bytes<D>(), in, OWN_ROWS,
                           OWN_ROWS, WG_ROWS, dq);
  } else if constexpr (sizeof(Elem) == 2 && D > 128) {
    return launch_wgmma<D>(flash_bwd_dq_wgmma_kernel<D>, dq_wgmma_smem_bytes<D>(), in, WG_ROWS,
                           WG_ROWS, WG_ROWS, dq);
  } else if constexpr (sizeof(Elem) == 2) {
    constexpr size_t smem = dq_mma_smem_bytes<D>();
    const auto kernel = flash_bwd_dq_mma_kernel<D>;
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(in), fa_mma::THREADS, smem, in.stream>>>(
        in_ptr<bf16>(in.q), in_ptr<bf16>(in.k), in_ptr<bf16>(in.v), in.seg, in.lse, in.delta,
        in_ptr<bf16>(in.dout), static_cast<bf16*>(dq), in.T, in.H, in.scale, in.causal);
    return cudaGetLastError();
  } else if constexpr (D <= 64) {
    return launch_f32(flash_bwd_dq_tf32_kernel<D>, dq_tf32_smem_bytes<D>(), in, fa_mma::ROWS,
                      fa_mma::THREADS, dq);
  } else if constexpr (D == 128) {
    return launch_f32(flash_bwd_dq_tf32_pair_kernel<D>, dq_pair_smem_bytes<D>(), in,
                      fa_mma::ROWS, PAIR_THREADS, dq);
  } else {
    return launch_f32(flash_bwd_dq_tf32_split_kernel<D>, dq_split_smem_bytes<D>(), in,
                      fa_mma::ROWS, SPLIT_THREADS, dq);
  }
}

template <typename Elem>
cudaError_t launch_dkv_d(int D, const Inputs& in, void* dk, void* dv) {
  switch (D) {
    case 32: return launch_dkv<32, Elem>(in, dk, dv);
    case 64: return launch_dkv<64, Elem>(in, dk, dv);
    case 128: return launch_dkv<128, Elem>(in, dk, dv);
    case 256: return launch_dkv<256, Elem>(in, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Elem>
cudaError_t launch_dq_d(int D, const Inputs& in, void* dq) {
  switch (D) {
    case 32: return launch_dq<32, Elem>(in, dq);
    case 64: return launch_dq<64, Elem>(in, dq);
    case 128: return launch_dq<128, Elem>(in, dq);
    case 256: return launch_dq<256, Elem>(in, dq);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, dk, dv: [B, T, H, D] of `bf16 ? bf16 : fp32`; lse, delta: fp32 [B, H, T]
extern "C" int roar_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const int* seg, const float* lse,
                                            const float* delta, const void* dout, void* dk,
                                            void* dv, int B, int T, int H, int D, float scale,
                                            int causal, int bf16, void* stream) {
  if (flash::bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  const Inputs in{q, k, v, seg, lse, delta, dout, B, T, H, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  if (bf16) return (int)launch_dkv_d<__nv_bfloat16>(D, in, dk, dv);
  return (int)launch_dkv_d<float>(D, in, dk, dv);
}

extern "C" int roar_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const int* seg, const float* lse, const float* delta,
                                           const void* dout, void* dq, int B, int T, int H,
                                           int D, float scale, int causal, int bf16,
                                           void* stream) {
  if (flash::bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  const Inputs in{q, k, v, seg, lse, delta, dout, B, T, H, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  if (bf16) return (int)launch_dq_d<__nv_bfloat16>(D, in, dq);
  return (int)launch_dq_d<float>(D, in, dq);
}
