// Segment-masked flash-attention forward, non-causal and causal, fp32 and
// bf16, for Hopper (sm_90a).
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
// [B, T] int32.  Two kernels, one contract:
//
// fp32, `flash_fwd_kernel` on the FMA pipe: one thread block per (64-query
// tile, head, batch row); 256 threads as a 16 x 16 grid: thread (ty, tx) owns
// query rows 4*ty .. 4*ty+3, score columns tx + 16*j of each 64-key tile, and
// output columns tx + 16*j.  K/V tiles are staged in shared memory as fp32;
// each row keeps a running max and sum (online softmax) and an fp32
// accumulator in registers, so the [T, T] scores never reach device memory.
// At D = 64 every fused multiply-add reads shared memory (one load per two
// FMAs), so the FMA pipe waits on shared-memory bandwidth, not on HBM.
//
// bf16, `flash_fwd_mma_kernel` on the tensor cores (mma.sync m16n8k16, fp32
// sums; flash_attention_mma.cuh): one block of 4 warps per (64-query tile,
// head, batch row), each warp owning 16 whole query rows, so that the row max
// and sum reduce within a lane quad and no barrier sits between the two
// products.  q.k^T is scaled in fp32 after the product; p stays in registers,
// its accumulator fragment rounded to bf16 as the A operand of p.v (its row
// sum taken unrounded); V is read by ldmatrix.trans.  K/V tiles of 64 keys are
// staged by cp.async into a double-buffered, swizzled bf16 layout, the next
// tile's copy overlapping the current tile's products.  What bounds it on the
// H100: the two products (4 B H T^2 D operations against the 989 TFLOP/s bf16
// peak) and, at D 64, as much again in per-element softmax work on the
// FMA and SFU pipes (scale, mask, max, exp, row sum, rescale of o); with 16
// rows a warp, every warp reads the whole K/V tile from shared memory.
// Later work: wgmma on 64-row warpgroup tiles with TMA staging and warp
// specialisation, 128-row query tiles, and a GQA-aware kernel (K/V are
// repeated before the call today).
//
// Both kernels: rows past T load as zeros and are never stored (T is never
// padded).  A K/V tile whose segment ids all lie outside the query tile's
// [min, max] segment range is skipped without being loaded (pad keys for a
// tile of valid queries, and the reverse).  With `causal` the key loop ends at
// the query tile's own diagonal tile, which is masked element by element, and
// the query tiles are handed out longest first, so that the short ones fill
// the tail.
//
// Training: when the caller passes `lse`, each in-range row also writes its
// log-sum-exp `m + log l` to lse[B, H, T] (one tensor in place of the TPU
// kernel's lane-broadcast `l` and `m`), the residual the backward kernels in
// flash_attention_bwd.cu recompute the probabilities from.  With a null
// pointer the kernel does what it did before.

#include <climits>

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"

namespace {

using namespace flash;

constexpr int BQ = TILE;    // query rows per block
constexpr int BK = TILE;    // keys per tile
constexpr int PS = BK + 1;  // padded row stride of the P tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS) +
         sizeof(int) * (BQ + BK);
}

// Shared memory lets three blocks of D <= 64 live on an SM (66 KB each) and
// one of D = 128: the register budget is set for that many, so that ptxas
// neither spills to fit a fourth block nor starves the third.
template <int D>
__global__ void __launch_bounds__(THREADS, (D <= 64 ? 3 : 1))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ out, float* __restrict__ lse, int T, int H, float scale,
                 int causal) {
  constexpr int DP = D + 1;   // padded row stride of the Q and K tiles
  constexpr int CJ = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][DP]
  float* Ks = Qs + BQ * DP;    // [BK][DP]
  float* Vs = Ks + BK * DP;    // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][PS]
  int* segq = reinterpret_cast<int*>(Ps + BQ * PS);  // [BQ]
  int* segk = segq + BQ;                             // [BK]
  __shared__ int qlo, qhi;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;  // elements between consecutive t
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;

  if (tid == 0) {
    qlo = INT_MAX;
    qhi = INT_MIN;
  }
  load_tile<D, DP>(Qs, q, base, ld, q0, T, tid);
  __syncthreads();
  if (tid < BQ) {
    const int s = (q0 + tid < T) ? segb[q0 + tid] : 0;
    segq[tid] = s;
    if (q0 + tid < T) {
      atomicMin(&qlo, s);
      atomicMax(&qhi, s);
    }
  }
  __syncthreads();

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  // causal: the tiles past the diagonal tile (k0 == q0) hold no visible key
  const int k_end = causal ? min(T, q0 + BQ) : T;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // Every read of the previous tile's segk finished before the barrier
    // that followed its P tile; this barrier also ends its reads of Vs/Ps.
    bool seen = false;
    if (tid < BK) {
      const int s = (k0 + tid < T) ? segb[k0 + tid] : 0;
      segk[tid] = s;
      seen = (k0 + tid < T) && s >= qlo && s <= qhi;
    }
    if (!__syncthreads_or(seen)) continue;

    load_tile<D, DP>(Ks, k, base, ld, k0, T, tid);
    load_tile<D, D>(Vs, v, base, ld, k0, T, tid);
    __syncthreads();
    // causal: key c of this tile is visible to row r when k0 + c <= q0 + r
    const int lim = causal ? q0 - k0 : BK;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int sq = segq[r];
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = (k0 + c < T) && segk[c] == sq && (c - r <= lim);
        s[i][j] = ok ? s[i][j] * scale : neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads sharing row r are one half-warp: lanes differing in
      // their low four bits
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen no visible key yet keeps m = -inf; exponents
      // are then taken against 0 so that no -inf - -inf makes a NaN
      const float m_use = (m_new == neg_inf()) ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[r * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t < T) {
      // l > 0: every in-range query sees at least its own key
      const float inv = 1.f / l[i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) out[base + t * ld + tx + 16 * j] = acc[i][j] * inv;
      if (lse != nullptr && tx == 0) lse[((long)b * H + h) * T + t] = m[i] + logf(l[i]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* out,
                   float* lse, int B, int T, int H, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, static_cast<float*>(out), lse, T, H, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* seg,
                     void* out, float* lse, int B, int T, int H, float scale, int causal,
                     cudaStream_t s) {
  switch (D) {
    case 32: return launch<32>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    case 64: return launch<64>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    case 128: return launch<128>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The bf16 form on the tensor cores.  One block of 4 warps per (64-query tile,
// head, batch row); warp w owns query rows 16 w .. 16 w + 15 whole, so a row's
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
  constexpr int TILE_ELEMS = ROWS * D;
  constexpr int KC = D / 16;  // k-chunks of q.k^T
  constexpr int NT = D / 8;   // n-tiles of the output

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

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* seg, void* out,
                       float* lse, int B, int T, int H, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + fa_mma::ROWS - 1) / fa_mma::ROWS, H, B);
  flash_fwd_mma_kernel<D><<<grid, fa_mma::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg, static_cast<__nv_bfloat16*>(out), lse, T, H,
      scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_mma_d(int D, const void* q, const void* k, const void* v, const int* seg,
                         void* out, float* lse, int B, int T, int H, float scale, int causal,
                         cudaStream_t s) {
  switch (D) {
    case 32: return launch_mma<32>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    case 64: return launch_mma<64>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    case 128: return launch_mma<128>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
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
  if (bf16) return (int)launch_mma_d(D, q, k, v, seg, out, lse, B, T, H, scale, causal, s);
  return (int)launch_d(D, q, k, v, seg, out, lse, B, T, H, scale, causal, s);
}

extern "C" const char* roar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
