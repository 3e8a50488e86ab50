// Segment-masked flash-attention backward, non-causal and causal, fp32 and
// bf16, for Hopper (sm_90a).
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
//   dkv kernel: one block per 64-key tile, looping over query tiles:
//               dV += p^T dout,  dK += dS^T q
//   dq kernel:  one block per 64-query tile, looping over key tiles:
//               dQ += dS k
// Every output element belongs to one thread of one block and is summed in a
// fixed order, so there are no float atomics and two runs give the same bits.
//
// fp32, `flash_bwd_dkv_kernel` and `flash_bwd_dq_kernel` on the FMA pipe: 256
// threads as a 16 x 16 grid.  In the tile products thread (ty, tx) owns query
// rows 4*ty .. 4*ty+3 and key columns tx + 16*j; in the accumulation it owns
// rows 4*ty .. 4*ty+3 of the block's own tile and head-dim columns tx + 16*j.
// p and dS pass through shared memory between the two, and every fused
// multiply-add reads shared memory.  (TF32 would not hold fp32's bar.)
//
// bf16, `flash_bwd_dkv_mma_kernel` and `flash_bwd_dq_mma_kernel` on the tensor
// cores (mma.sync m16n8k16, fp32 sums; flash_attention_mma.cuh), 4 warps a
// block.  dK/dV: each warp owns 16 keys of the block's 64-key tile as the rows
// of S^T = K q^T and dP^T = V dO^T, so that P^T and dS^T come out of the
// accumulators as the A operands of dV += P^T dO and dK += dS^T q without
// leaving registers; q and dO tiles are double-buffered by cp.async.  dQ: each
// warp owns 16 queries of the block's 64-query tile as the rows of S = q K^T
// and dP = dO V^T, 16 keys at a time, so that the two n-tiles of one 16-key
// chunk of dS are the A operand of dQ += dS K; K and V tiles are
// double-buffered by cp.async.  The second products read their B operand by
// ldmatrix.trans; dQ, dK and dV stay fp32 in registers and are rounded once.
//
// What bounds them on the H100: the function is five T x T x D products
// (10 B H T^2 D operations); the split into two kernels recomputes q.k^T and
// dout.v^T, so seven are done.  The tensor-core dK/dV kernel's four products
// (8 pairs D operations) and the dQ kernel's three (6 pairs D) are held
// against the 989 TFLOP/s bf16 peak; at D 64 their per-element work (exp,
// masks, dS) on the FMA and SFU pipes is of the same order.  What holds them
// back from it: `mma.sync` rather than `wgmma`, every warp reading the whole
// staged tile of the other side from shared memory (one ldmatrix per two
// mma.sync), and cp.async rather than TMA.  The design masks the ragged edge in
// the kernel (T is never padded), and skips a tile whose segment ids all lie
// outside the block's own [min, max] segment range without loading it.  With
// `causal` the tiles above the diagonal are skipped too: the dkv loop over
// query tiles starts at the key tile's own row, the dq loop over key tiles
// ends at the query tile's own column, and the diagonal tile is masked element
// by element; the dq kernels hand their query tiles out longest first (the dkv
// kernels' first key tile is their longest already).
// Later work: wgmma / TMA, a fused five-product backward, and a GQA-aware
// kernel.

#include <climits>

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"

namespace {

using namespace flash;

constexpr int BM = TILE;    // tile rows (queries) and columns (keys)
constexpr int PS = BM + 1;  // padded row stride of the p and dS tiles

template <int D>
constexpr size_t smem_bytes(int n_prob_tiles) {
  return sizeof(float) * (4 * BM * (D + 1) + n_prob_tiles * BM * PS + 2 * BM) +
         sizeof(int) * (2 * BM);
}

// s[i][j] = sum_d a[4*ty + i][d] * b[tx + 16*j][d]
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int ty, int tx,
                                         float (&s)[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// p and dS of one 64 x 64 tile from the staged Q, K, V, dO tiles, written to
// shared memory (Ps may be null when only dS is wanted)
template <int D>
__device__ __forceinline__ void prob_tile(const float* Qs, const float* Ks, const float* Vs,
                                          const float* Os, const int* segq, const int* segk,
                                          const float* lse_s, const float* delta_s, int q0,
                                          int k0, int T, float scale, int causal, int ty,
                                          int tx, float* Ps, float* Ss) {
  // causal: key c of this tile is visible to row r when k0 + c <= q0 + r
  const int lim = causal ? q0 - k0 : BM;
  float s[4][4], dp[4][4];
  tile_dot<D>(Qs, Ks, ty, tx, s);
  tile_dot<D>(Os, Vs, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int sq = segq[r];
    const float row_lse = lse_s[r], row_delta = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool ok = (q0 + r < T) && (k0 + c < T) && segk[c] == sq && (c - r <= lim);
      const float p = ok ? expf(s[i][j] * scale - row_lse) : 0.f;
      if (Ps != nullptr) Ps[r * PS + c] = p;
      Ss[r * PS + c] = p * (dp[i][j] - row_delta) * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ dout, float* __restrict__ dk,
                     float* __restrict__ dv, int T, int H, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int CJ = D / 16;

  extern __shared__ float smem[];
  float* Ks = smem;             // [BM][DP], this block's keys
  float* Vs = Ks + BM * DP;     // [BM][DP]
  float* Qs = Vs + BM * DP;     // [BM][DP], the query tile in flight
  float* Os = Qs + BM * DP;     // [BM][DP], its dout rows
  float* Ps = Os + BM * DP;     // [BM][PS]
  float* Ss = Ps + BM * PS;     // [BM][PS]
  float* lse_s = Ss + BM * PS;  // [BM]
  float* delta_s = lse_s + BM;  // [BM]
  int* segq = reinterpret_cast<int*>(delta_s + BM);  // [BM]
  int* segk = segq + BM;                             // [BM]
  __shared__ int klo, khi;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  if (tid == 0) {
    klo = INT_MAX;
    khi = INT_MIN;
  }
  load_tile<D, DP>(Ks, k, base, ld, k0, T, tid);
  load_tile<D, DP>(Vs, v, base, ld, k0, T, tid);
  __syncthreads();
  if (tid < BM) {
    const int s = (k0 + tid < T) ? segb[k0 + tid] : 0;
    segk[tid] = s;
    if (k0 + tid < T) {
      atomicMin(&klo, s);
      atomicMax(&khi, s);
    }
  }
  __syncthreads();

  float acc_dk[4][CJ], acc_dv[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // causal: the query tiles before this key tile's own row see none of its keys
  for (int q0 = causal ? k0 : 0; q0 < T; q0 += BM) {
    // The previous tile's reads of segq, lse_s and delta_s ended before the
    // barrier that followed its p and dS tiles; the barrier below also ends
    // its reads of Qs, Os, Ps and Ss.
    bool seen = false;
    if (tid < BM) {
      const bool in = q0 + tid < T;
      const int s = in ? segb[q0 + tid] : 0;
      segq[tid] = s;
      lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      seen = in && s >= klo && s <= khi;
    }
    if (!__syncthreads_or(seen)) continue;

    load_tile<D, DP>(Qs, q, base, ld, q0, T, tid);
    load_tile<D, DP>(Os, dout, base, ld, q0, T, tid);
    __syncthreads();
    prob_tile<D>(Qs, Ks, Vs, Os, segq, segk, lse_s, delta_s, q0, k0, T, scale, causal, ty, tx,
                    Ps, Ss);
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float pv[4], sv[4], ov[CJ], qv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * PS + ty * 4 + i];
        sv[i] = Ss[r * PS + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        ov[j] = Os[r * DP + tx + 16 * j];
        qv[j] = Qs[r * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          acc_dv[i][j] = fmaf(pv[i], ov[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(sv[i], qv[j], acc_dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t < T) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        dk[base + t * ld + tx + 16 * j] = acc_dk[i][j];
        dv[base + t * ld + tx + 16 * j] = acc_dv[i][j];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ seg,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ dout, float* __restrict__ dq, int T, int H,
                    float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int CJ = D / 16;

  extern __shared__ float smem[];
  float* Qs = smem;             // [BM][DP], this block's queries
  float* Os = Qs + BM * DP;     // [BM][DP], their dout rows
  float* Ks = Os + BM * DP;     // [BM][DP], the key tile in flight
  float* Vs = Ks + BM * DP;     // [BM][DP]
  float* Ss = Vs + BM * DP;     // [BM][PS]
  float* lse_s = Ss + BM * PS;  // [BM]
  float* delta_s = lse_s + BM;  // [BM]
  int* segq = reinterpret_cast<int*>(delta_s + BM);  // [BM]
  int* segk = segq + BM;                             // [BM]
  __shared__ int qlo, qhi;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  if (tid == 0) {
    qlo = INT_MAX;
    qhi = INT_MIN;
  }
  load_tile<D, DP>(Qs, q, base, ld, q0, T, tid);
  load_tile<D, DP>(Os, dout, base, ld, q0, T, tid);
  __syncthreads();
  if (tid < BM) {
    const bool in = q0 + tid < T;
    const int s = in ? segb[q0 + tid] : 0;
    segq[tid] = s;
    lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
    delta_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
    if (in) {
      atomicMin(&qlo, s);
      atomicMax(&qhi, s);
    }
  }
  __syncthreads();

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  // causal: the tiles past the diagonal tile (k0 == q0) hold no visible key
  const int k_end = causal ? min(T, q0 + BM) : T;
  for (int k0 = 0; k0 < k_end; k0 += BM) {
    // segk of the previous tile was last read before the barrier that
    // followed its dS tile; the barrier below also ends its reads of Ks and Ss.
    bool seen = false;
    if (tid < BM) {
      const int s = (k0 + tid < T) ? segb[k0 + tid] : 0;
      segk[tid] = s;
      seen = (k0 + tid < T) && s >= qlo && s <= qhi;
    }
    if (!__syncthreads_or(seen)) continue;

    load_tile<D, DP>(Ks, k, base, ld, k0, T, tid);
    load_tile<D, DP>(Vs, v, base, ld, k0, T, tid);
    __syncthreads();
    prob_tile<D>(Qs, Ks, Vs, Os, segq, segk, lse_s, delta_s, q0, k0, T, scale, causal, ty, tx,
                    nullptr, Ss);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BM; ++c) {
      float kv[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ss[(ty * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t < T) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) dq[base + t * ld + tx + 16 * j] = acc[i][j];
    }
  }
}

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
  constexpr int TILE_ELEMS = ROWS * D;
  constexpr int KC = D / 16;  // k-chunks of the two score products
  constexpr int NT = D / 8;   // n-tiles of dK and dV
  // D 128 reads its K and V fragments from shared memory per chunk, to stay
  // clear of spills; narrower heads hold them in registers
  constexpr bool KV_IN_REGS = D <= 64;

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
  uint32_t ka[KV_IN_REGS ? KC : 1][4], va[KV_IN_REGS ? KC : 1][4];
  if constexpr (KV_IN_REGS) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      load_a<D>(ka[kc], Ks, warp * 16, kc, lane);
      load_a<D>(va[kc], Vs, warp * 16, kc, lane);
    }
  }

  float acc_dk[NT][4], acc_dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

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

    // D 128 keeps 128 accumulators a thread: one chunk at a time, so that the
    // next chunk's fragment loads are not hoisted into registers it lacks
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
          load_a<D>(vf, Vs, warp * 16, kc, lane);
        }
        load_b<D>(qb, Qt, c * 16, kc, lane);
        load_b<D>(ob, Ot, c * 16, kc, lane);
        mma_bf16(st[0], kf, qb[0], qb[1]);
        mma_bf16(st[1], kf, qb[2], qb[3]);
        mma_bf16(dpt[0], vf, ob[0], ob[1]);
        mma_bf16(dpt[1], vf, ob[2], ob[3]);
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
// a fixed order: no atomics, two runs give the same bits.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * fa_mma::ROWS * D * 6;  // Q, dO, then K and V x 2
}

template <int D>
__global__ void __launch_bounds__(fa_mma::THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                        int T, int H, float scale, int causal) {
  using namespace fa_mma;
  constexpr int TILE_ELEMS = ROWS * D;
  constexpr int KC = D / 16;  // k-chunks of the two score products
  constexpr int NT = D / 8;   // n-tiles of dQ
  // D 128 reads its Q and dO fragments from shared memory per chunk, to stay
  // clear of spills; narrower heads hold them in registers
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

    // D 128 keeps 64 accumulators a thread: one chunk at a time, so that the
    // next chunk's fragment loads are not hoisted into registers it lacks
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

template <int D>
cudaError_t launch_dkv(const Inputs& in, void* dk, void* dv) {
  constexpr size_t smem = smem_bytes<D>(2);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((in.T + BM - 1) / BM, in.H, in.B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, in.stream>>>(
      static_cast<const float*>(in.q), static_cast<const float*>(in.k),
      static_cast<const float*>(in.v), in.seg, in.lse, in.delta,
      static_cast<const float*>(in.dout), static_cast<float*>(dk), static_cast<float*>(dv),
      in.T, in.H, in.scale, in.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Inputs& in, void* dq) {
  constexpr size_t smem = smem_bytes<D>(1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((in.T + BM - 1) / BM, in.H, in.B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, in.stream>>>(
      static_cast<const float*>(in.q), static_cast<const float*>(in.k),
      static_cast<const float*>(in.v), in.seg, in.lse, in.delta,
      static_cast<const float*>(in.dout), static_cast<float*>(dq), in.T, in.H, in.scale,
      in.causal);
  return cudaGetLastError();
}

cudaError_t launch_dkv_d(int D, const Inputs& in, void* dk, void* dv) {
  switch (D) {
    case 32: return launch_dkv<32>(in, dk, dv);
    case 64: return launch_dkv<64>(in, dk, dv);
    case 128: return launch_dkv<128>(in, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_dkv_mma(const Inputs& in, void* dk, void* dv) {
  constexpr size_t smem = dkv_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((in.T + fa_mma::ROWS - 1) / fa_mma::ROWS, in.H, in.B);
  flash_bwd_dkv_mma_kernel<D><<<grid, fa_mma::THREADS, smem, in.stream>>>(
      static_cast<const __nv_bfloat16*>(in.q), static_cast<const __nv_bfloat16*>(in.k),
      static_cast<const __nv_bfloat16*>(in.v), in.seg, in.lse, in.delta,
      static_cast<const __nv_bfloat16*>(in.dout), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), in.T, in.H, in.scale, in.causal);
  return cudaGetLastError();
}

cudaError_t launch_dkv_mma_d(int D, const Inputs& in, void* dk, void* dv) {
  switch (D) {
    case 32: return launch_dkv_mma<32>(in, dk, dv);
    case 64: return launch_dkv_mma<64>(in, dk, dv);
    case 128: return launch_dkv_mma<128>(in, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_dq_d(int D, const Inputs& in, void* dq) {
  switch (D) {
    case 32: return launch_dq<32>(in, dq);
    case 64: return launch_dq<64>(in, dq);
    case 128: return launch_dq<128>(in, dq);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_dq_mma(const Inputs& in, void* dq) {
  constexpr size_t smem = dq_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((in.T + fa_mma::ROWS - 1) / fa_mma::ROWS, in.H, in.B);
  flash_bwd_dq_mma_kernel<D><<<grid, fa_mma::THREADS, smem, in.stream>>>(
      static_cast<const __nv_bfloat16*>(in.q), static_cast<const __nv_bfloat16*>(in.k),
      static_cast<const __nv_bfloat16*>(in.v), in.seg, in.lse, in.delta,
      static_cast<const __nv_bfloat16*>(in.dout), static_cast<__nv_bfloat16*>(dq), in.T, in.H,
      in.scale, in.causal);
  return cudaGetLastError();
}

cudaError_t launch_dq_mma_d(int D, const Inputs& in, void* dq) {
  switch (D) {
    case 32: return launch_dq_mma<32>(in, dq);
    case 64: return launch_dq_mma<64>(in, dq);
    case 128: return launch_dq_mma<128>(in, dq);
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
  if (bf16) return (int)launch_dkv_mma_d(D, in, dk, dv);
  return (int)launch_dkv_d(D, in, dk, dv);
}

extern "C" int roar_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const int* seg, const float* lse, const float* delta,
                                           const void* dout, void* dq, int B, int T, int H,
                                           int D, float scale, int causal, int bf16,
                                           void* stream) {
  if (flash::bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  const Inputs in{q, k, v, seg, lse, delta, dout, B, T, H, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  if (bf16) return (int)launch_dq_mma_d(D, in, dq);
  return (int)launch_dq_d(D, in, dq);
}
