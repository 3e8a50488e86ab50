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
// Head sizes 32, 64, 128 and 256 in both types.  bf16 at D 256 (192 to 196
// KB of shared memory a block): a launch forms half of the output columns,
// and the dK/dV kernel runs dV and dK as separate passes (see the bf16
// kernel's notes).  fp32 at D 256: the split kernels, 8 warps a block, each
// score tile formed once and each kernel one launch (see their notes).
//
// Up to D 128 (and in bf16 at D 256) both types share one block layout, 4
// warps a block.  dK/dV: each warp owns
// 16 keys of the block's 64-key tile as the rows of S^T = K q^T and
// dP^T = V dO^T, so that P^T and dS^T come out of the accumulators as the A
// operands of dV += P^T dO and dK += dS^T q without leaving registers; q and dO
// tiles are staged by cp.async.  dQ: each warp owns 16 queries of the block's
// 64-query tile as the rows of S = q K^T and dP = dO V^T, so that dS is the A
// operand of dQ += dS K; K and V tiles are staged by cp.async.  dQ, dK and dV
// stay fp32 in registers until they are stored.
//
// bf16, `flash_bwd_dkv_mma_kernel` and `flash_bwd_dq_mma_kernel`: mma.sync
// m16n8k16 with fp32 sums (flash_attention_mma.cuh) on XOR-swizzled bf16
// tiles; the accumulators of two neighbouring 8-wide n-tiles are, element for
// element, the A fragment of one 16-wide k-chunk of the next product; the
// second products read their B operand by ldmatrix.trans; the streamed tiles
// are double-buffered.
//
// fp32, `flash_bwd_dkv_tf32_kernel` and `flash_bwd_dq_tf32_kernel` (up to
// D 128; the D 256 split kernels share their arithmetic): mma.sync m16n8k8
// on TF32 in 3xTF32 (tf32x3.cuh): every fp32 operand is split into
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
// the 67 TFLOP/s of the FMA pipe).  What holds them back from it: `mma.sync`
// rather than `wgmma`, every warp reading the whole staged tile of the other
// side from shared memory, cp.async rather than TMA, per-element work (exp,
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
// already).  In bf16 at D 256 the passes and column halves do eight (dK/dV)
// and five (dQ) products where four and three would do, with one block a
// SM.  The fp32 split kernels at D 256 do four and three, 8 warps a block
// (one a SM), and split every operand word as it is loaded (the price of
// two stages of streamed tiles in 216,064 B): at (1, 2048, 8, 256) causal
// dK/dV 1.570 / 1.519 ms and dQ 1.189 / 1.167 (13 / 13 % of their own
// bounds) where the passes and halves took 5.034 / 5.115 and 2.872 / 2.844
// (NVIDIA H100 80GB HBM3, 700.00 W, `scripts/flash_kernel_times_torch.py`).
// Later work: wgmma / TMA (TF32 wgmma for fp32), the split layout for the
// bf16 D 256 backward, a fused five-product backward, and a GQA-aware
// kernel.

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"
#include "flash_attention_tf32.cuh"

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
//
// `PASS`: 0 forms dK and dV in one loop.  At D 256 the two would take 256
// accumulator registers a thread before anything else, so the launch runs
// the kernel for dV (PASS 1: no dP^T, no V tile) and for dK (PASS 2), each
// over half of the columns at a time (`NCOL` 128 at `col0` 0 and 128): four
// launches, each recomputing S^T (and dP^T for dK) and holding 64
// accumulators (with a whole dV or dK, 128 of them, ptxas spilled).
// Each output comes out of the same sums in the same order as in one pass.
// ---------------------------------------------------------------------------

namespace fa_mma = flash::mma;

constexpr int DKV_BOTH = 0, DKV_DV = 1, DKV_DK = 2;

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V, then Q and dO x 2; lse and delta rows x 2
  return sizeof(__nv_bfloat16) * fa_mma::ROWS * D * 6 + sizeof(float) * fa_mma::ROWS * 4;
}

template <int D, int PASS, int NCOL>
__global__ void __launch_bounds__(fa_mma::THREADS)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int T, int H, float scale, int causal,
                         int col0_arg) {
  using namespace fa_mma;
  constexpr int TILE_ELEMS = ROWS * D;
  constexpr int KC = D / 16;    // k-chunks of the two score products
  constexpr int NT = NCOL / 8;  // n-tiles of this block's columns of dK and dV
  // the first column, a multiple of 64 (see swizzle_at)
  const int col0 = NCOL == D ? 0 : col0_arg;
  // D 128 and 256 read their K and V fragments from shared memory per chunk,
  // to stay clear of spills; narrower heads hold them in registers
  constexpr bool KV_IN_REGS = D <= 64;
  constexpr bool DO_DV = PASS != DKV_DK, DO_DK = PASS != DKV_DV;

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
  if constexpr (DO_DK) stage_tile<D>(Vs, v, base, ld, k0, T, tid);
  cp_async_commit();
  // causal: the query tiles before this key tile's own row see none of its keys
  bool uniform, uniform_next;
  int q0 = next_tile(segb, causal ? k0 : 0, T, T, klo, khi, lane, uniform);
  if (q0 < T) {
    stage_tile<D>(Qs, q, base, ld, q0, T, tid);
    stage_tile<D>(Os, dout, base, ld, q0, T, tid);
    stage_rows(lse_s, lse + row_base, q0, T, tid);
    if constexpr (DO_DK) stage_rows(delta_s, delta + row_base, q0, T, tid);
  }
  cp_async_commit();

  // this thread's two keys, rows g and g + 8 of the warp's 16
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const int seg0 = key0 < T ? segb[key0] : -1, seg1 = key1 < T ? segb[key1] : -1;

  cp_async_wait<1>();
  __syncthreads();
  uint32_t ka[KV_IN_REGS ? KC : 1][4], va[KV_IN_REGS ? KC : 1][4];
  if constexpr (KV_IN_REGS) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      load_a<D>(ka[kc], Ks, warp * 16, kc, lane);
      load_a<D>(va[kc], Vs, warp * 16, kc, lane);
    }
  }

  float acc_dk[DO_DK ? NT : 1][4], acc_dv[DO_DV ? NT : 1][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (DO_DK) acc_dk[j][e] = 0.f;
      if constexpr (DO_DV) acc_dv[j][e] = 0.f;
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
      if constexpr (DO_DK) stage_rows(delta_s + nx * ROWS, delta + row_base, qn, T, tid);
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

    // D 128 keeps 128 accumulators a thread (each pass at D 256 64): one
    // chunk at a time, so that the next chunk's fragment loads are not hoisted
    // into registers it lacks
#pragma unroll(KV_IN_REGS ? ROWS / 16 : 1)
    for (int c = 0; c < ROWS / 16; ++c) {  // queries 16 c .. 16 c + 15 of the tile
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t kf[4], vf[4], qb[4], ob[4];
        if constexpr (KV_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kf[i] = ka[kc][i];
            vf[i] = va[kc][i];
          }
        } else {
          load_a<D>(kf, Ks, warp * 16, kc, lane);
          if constexpr (DO_DK) load_a<D>(vf, Vs, warp * 16, kc, lane);
        }
        // one pass issues both B loads before its products (a D 64 kernel
        // that loaded dO after S's products ran 10 to 15 % slower on an H100)
        load_b<D>(qb, Qt, c * 16, kc, lane);
        if constexpr (PASS == DKV_BOTH) load_b<D>(ob, Ot, c * 16, kc, lane);
        mma_bf16(st[0], kf, qb[0], qb[1]);
        mma_bf16(st[1], kf, qb[2], qb[3]);
        if constexpr (DO_DK) {
          if constexpr (PASS != DKV_BOTH) load_b<D>(ob, Ot, c * 16, kc, lane);
          mma_bf16(dpt[0], vf, ob[0], ob[1]);
          mma_bf16(dpt[1], vf, ob[2], ob[3]);
        }
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
          if constexpr (DO_DK)
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
      for (int np = 0; np < NCOL / 16; ++np) {
        uint32_t ob[4], qb[4];
        if constexpr (DO_DV) {
          load_b_trans<D>(ob, Ot + col0, c * 16, np, lane);
          mma_bf16(acc_dv[2 * np], pa, ob[0], ob[1]);
          mma_bf16(acc_dv[2 * np + 1], pa, ob[2], ob[3]);
        }
        if constexpr (DO_DK) {
          load_b_trans<D>(qb, Qt + col0, c * 16, np, lane);
          mma_bf16(acc_dk[2 * np], sa, qb[0], qb[1]);
          mma_bf16(acc_dk[2 * np + 1], sa, qb[2], qb[3]);
        }
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
      const long at = base + (long)t * ld + col0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if constexpr (DO_DK)
          *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
              __floats2bfloat162_rn(acc_dk[j][2 * i], acc_dk[j][2 * i + 1]);
        if constexpr (DO_DV)
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
// a fixed order: no atomics, two runs give the same bits.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * fa_mma::ROWS * D * 6;  // Q, dO, then K and V x 2
}

// Blocks a SM: up to D 128 ptxas chose at most 168 registers (three blocks
// of 128 threads) by itself, and the bound keeps that; at D 256 one block
// fits in shared memory, and with no bound ptxas still aimed at three and
// spilled 40 B at 168 registers
template <int D, int NCOL>
__global__ void __launch_bounds__(fa_mma::THREADS, D > 128 ? 1 : 3)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                        int T, int H, float scale, int causal, int col0_arg) {
  using namespace fa_mma;
  constexpr int TILE_ELEMS = ROWS * D;
  constexpr int KC = D / 16;    // k-chunks of the two score products
  constexpr int NT = NCOL / 8;  // n-tiles of this block's columns of dQ
  // the first column, a multiple of 64 (see swizzle_at)
  const int col0 = NCOL == D ? 0 : col0_arg;
  // D 128 and 256 read their Q and dO fragments from shared memory per chunk,
  // to stay clear of spills; narrower heads hold them in registers
  constexpr bool QO_IN_REGS = D <= 64;

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
  uint32_t qa[QO_IN_REGS ? KC : 1][4], oa[QO_IN_REGS ? KC : 1][4];
  if constexpr (QO_IN_REGS) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      load_a<D>(qa[kc], Qs, warp * 16, kc, lane);
      load_a<D>(oa[kc], Os, warp * 16, kc, lane);
    }
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

    // D 128 keeps 64 accumulators a thread (each column half at D 256 too):
    // one chunk at a time, so that the next chunk's fragment loads are not
    // hoisted into registers it lacks
#pragma unroll(QO_IN_REGS ? ROWS / 16 : 1)
    for (int c = 0; c < ROWS / 16; ++c) {  // keys 16 c .. 16 c + 15 of the tile
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qf[4], of[4], kb[4], vb[4];
        if constexpr (QO_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qf[i] = qa[kc][i];
            of[i] = oa[kc][i];
          }
        } else {
          load_a<D>(qf, Qs, warp * 16, kc, lane);
          load_a<D>(of, Os, warp * 16, kc, lane);
        }
        load_b<D>(kb, Kt, c * 16, kc, lane);
        load_b<D>(vb, Vt, c * 16, kc, lane);
        mma_bf16(s[0], qf, kb[0], kb[1]);
        mma_bf16(s[1], qf, kb[2], kb[3]);
        mma_bf16(dp[0], of, vb[0], vb[1]);
        mma_bf16(dp[1], of, vb[2], vb[3]);
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
      for (int np = 0; np < NCOL / 16; ++np) {
        uint32_t kb[4];
        load_b_trans<D>(kb, Kt + col0, c * 16, np, lane);
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
      __nv_bfloat16* dst = dq + base + (long)t * ld + col0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 kernels on the tensor cores, 3xTF32 (see the notes at the top).
// Up to D 128: the block's own tiles (K and V for dK/dV, Q and dO for dQ)
// stay fp32 and each A fragment is split after its load; the streamed tiles
// of the other side, read as B operands by all four warps in both products,
// are split once per tile in shared memory into a big and a small half (TF32
// bit patterns).  At D 256 that layout would ask for 399,872 B (dK/dV) and
// 399,360 B (dQ) of shared memory (the card grants a block 232,448) and a
// whole row of dK and dV 256 accumulators a thread: see the D 256 kernels
// further down.
// ---------------------------------------------------------------------------

using namespace flash::tf32;

// ---------------------------------------------------------------------------
// The fp32 dK/dV kernel up to D 128.  One block of 4 warps per 64-key tile;
// warp w owns keys 16 w .. 16 w + 15 whole, as the rows of
//   S^T = K Q^T  and  dP^T = V dO^T   (K and V as A fragments),
// and loops over the visible 64-query tiles (from the diagonal with
// `causal`), 8 NQ queries at a time:
//   P^T  = exp(S^T * scale - lse)            (0 where masked)
//   dS^T = P^T o (dP^T - delta) * scale
//   dV  += P^T dO,   dK += dS^T Q             (dO and Q rows read permuted)
// Each query tile is staged by cp.async with its lse / delta rows and split in
// place; one stage, so the copies of the next tile wait for this one's
// products (two blocks a SM at D <= 64 overlap each other's).
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
  static_assert(D <= 128, "D 256 runs flash_bwd_dkv_tf32_split_kernel");
  constexpr int TW = ROWS * (D + 4);  // words of a staged tile or half
  constexpr int KC = D / 8;           // k-chunks of the score products
  constexpr int NT = D / 8;           // n-tiles of dK and dV
  // 8-query n-tiles a chunk, in pairs; D 128 takes 16 queries a chunk
  constexpr int NQ = D <= 64 ? 4 : 2;
  // the score products' k-chunks unroll whole up to D 64, 4 times above; the
  // output n-tiles unroll whole but at D 128, whose 128 accumulators a
  // thread live in the stack frame
  constexpr int UNROLL = D <= 64 ? KC : 4;
  constexpr int UNROLL_OUT = D == 128 ? 4 : NT;

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
#pragma unroll(UNROLL)
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
#pragma unroll(UNROLL_OUT)
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
// The fp32 dQ kernel up to D 128.  One block of 4 warps per (64-query tile,
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
  static_assert(D <= 128, "D 256 runs flash_bwd_dq_tf32_split_kernel");
  constexpr int TW = ROWS * (D + 4);
  constexpr int KC = D / 8;  // k-chunks of the score products
  constexpr int NT = D / 8;  // n-tiles of dQ
  // 8-key n-tiles a chunk, in pairs; D 128 takes 16 keys a chunk
  constexpr int NK = D <= 64 ? 4 : 2;
  // unrolled as in dK/dV: D 128's 64 accumulators live in the stack frame
  constexpr int UNROLL = D <= 64 ? KC : 4;
  constexpr int UNROLL_OUT = D == 128 ? 4 : NT;

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
#pragma unroll(UNROLL)
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
#pragma unroll(UNROLL_OUT)
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
// the gradient products through the permuted contraction index, as up to
// D 128.  Every operand word is kept unsplit in shared memory and split as
// it is loaded, which leaves the room for two stages of streamed tiles: the
// next tile's cp.async runs under this tile's products.  `tests/
// test_torch_flash_tf32.py` emulates this walk (`D256_WALK`): the split sums
// hold the fp32 bar, and plain TF32 fails it.
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 256;  // 8 warps
constexpr int SPLIT_KEYS = 32;      // dK/dV: keys of a block, queries of a streamed tile
constexpr int SPLIT_DQ_KEYS = 16;   // dQ: keys of a streamed tile (64 queries a block)

// named barrier `id` (1..) over `threads` threads of the block
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

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

// the output columns a bf16 launch forms: all of them, and half of them at
// D 256
template <int D>
constexpr int ncol() {
  return D > 128 ? D / 2 : D;
}

// bf16: one launch of 4 warps per `ncol` columns (two at D 256)
template <int D, int PASS>
cudaError_t launch_dkv_mma_pass(const Inputs& in, void* dk, void* dv) {
  constexpr size_t smem = dkv_mma_smem_bytes<D>();
  const auto kernel = flash_bwd_dkv_mma_kernel<D, PASS, ncol<D>()>;
  cudaError_t err = prepare(kernel, smem);
  for (int col0 = 0; err == cudaSuccess && col0 < D; col0 += ncol<D>()) {
    kernel<<<grid_of(in), fa_mma::THREADS, smem, in.stream>>>(
        in_ptr<bf16>(in.q), in_ptr<bf16>(in.k), in_ptr<bf16>(in.v), in.seg, in.lse, in.delta,
        in_ptr<bf16>(in.dout), static_cast<bf16*>(dk), static_cast<bf16*>(dv), in.T, in.H,
        in.scale, in.causal, col0);
    err = cudaGetLastError();
  }
  return err;
}

// `Elem` is float (the 3xTF32 kernels) or bf16 (the bf16 kernels).
// bf16 at D 256: the dV pass before the dK pass (see the dK/dV kernels'
// notes); fp32 at D 256: the split kernel, one launch of 8 warps per 32-key
// tile
template <int D, typename Elem>
cudaError_t launch_dkv(const Inputs& in, void* dk, void* dv) {
  if constexpr (sizeof(Elem) == 2 && D > 128) {
    const cudaError_t err = launch_dkv_mma_pass<D, DKV_DV>(in, dk, dv);
    if (err != cudaSuccess) return err;
    return launch_dkv_mma_pass<D, DKV_DK>(in, dk, dv);
  } else if constexpr (sizeof(Elem) == 2) {
    return launch_dkv_mma_pass<D, DKV_BOTH>(in, dk, dv);
  } else {
    constexpr bool split = D > 128;
    constexpr size_t smem = split ? dkv_split_smem_bytes<D>() : dkv_tf32_smem_bytes<D>();
    const auto kernel = [] {
      if constexpr (split) return flash_bwd_dkv_tf32_split_kernel<D>;
      else return flash_bwd_dkv_tf32_kernel<D>;
    }();
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(in, split ? SPLIT_KEYS : fa_mma::ROWS),
             split ? SPLIT_THREADS : fa_mma::THREADS, smem, in.stream>>>(
        in_ptr<float>(in.q), in_ptr<float>(in.k), in_ptr<float>(in.v), in.seg, in.lse, in.delta,
        in_ptr<float>(in.dout), static_cast<float*>(dk), static_cast<float*>(dv), in.T, in.H,
        in.scale, in.causal);
    return cudaGetLastError();
  }
}

// one launch a call but for bf16 at D 256 (one per column half); fp32 at
// D 256: the split kernel, 8 warps per 64-query tile
template <int D, typename Elem>
cudaError_t launch_dq(const Inputs& in, void* dq) {
  if constexpr (sizeof(Elem) == 2) {
    constexpr size_t smem = dq_mma_smem_bytes<D>();
    const auto kernel = flash_bwd_dq_mma_kernel<D, ncol<D>()>;
    cudaError_t err = prepare(kernel, smem);
    for (int col0 = 0; err == cudaSuccess && col0 < D; col0 += ncol<D>()) {
      kernel<<<grid_of(in), fa_mma::THREADS, smem, in.stream>>>(
          in_ptr<bf16>(in.q), in_ptr<bf16>(in.k), in_ptr<bf16>(in.v), in.seg, in.lse, in.delta,
          in_ptr<bf16>(in.dout), static_cast<bf16*>(dq), in.T, in.H, in.scale, in.causal, col0);
      err = cudaGetLastError();
    }
    return err;
  } else {
    constexpr bool split = D > 128;
    constexpr size_t smem = split ? dq_split_smem_bytes<D>() : dq_tf32_smem_bytes<D>();
    const auto kernel = [] {
      if constexpr (split) return flash_bwd_dq_tf32_split_kernel<D>;
      else return flash_bwd_dq_tf32_kernel<D>;
    }();
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(in), split ? SPLIT_THREADS : fa_mma::THREADS, smem, in.stream>>>(
        in_ptr<float>(in.q), in_ptr<float>(in.k), in_ptr<float>(in.v), in.seg, in.lse, in.delta,
        in_ptr<float>(in.dout), static_cast<float*>(dq), in.T, in.H, in.scale, in.causal);
    return cudaGetLastError();
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
