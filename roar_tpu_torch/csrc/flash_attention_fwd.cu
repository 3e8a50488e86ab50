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
// [B, T] int32.
// One thread block per (64-query tile, head, batch row); 256 threads as a
// 16 x 16 grid: thread (ty, tx) owns query rows 4*ty .. 4*ty+3, score columns
// tx + 16*j of each 64-key tile, and output columns tx + 16*j.  K/V tiles are
// staged in shared memory; each row keeps a running max and sum (online
// softmax) and an fp32 accumulator in registers, so the [T, T] scores never
// reach device memory.  The ragged edge (T not a multiple of 64) is masked
// in the kernel: rows past T load as zeros and are never stored.
//
// What bounds it on the H100: at D = 64 in fp32 the block streams all of K
// and V once per 64-query tile (T/64 passes over K/V in all), and every
// fused multiply-add reads shared memory (one load per two FMAs), so the
// FMA pipe waits on shared-memory bandwidth, not on HBM.  What the design
// does about it: a K/V tile whose segment ids all lie outside the query
// tile's [min, max] segment range is skipped without being loaded (pad keys
// for a tile of valid queries, and the reverse): when half of a decoder
// bucket is padding, about half the passes.  With `causal` the key loop ends
// at the query tile's own diagonal tile (about half the passes again), and
// the query tiles are handed out longest first, so that the short ones fill
// the tail.  The bf16 form halves the bytes but still multiplies on the FMA
// pipe: tensor cores (wgmma) and TMA are later work.
//
// Training: when the caller passes `lse`, each in-range row also writes its
// log-sum-exp `m + log l` to lse[B, H, T] (one tensor in place of the TPU
// kernel's lane-broadcast `l` and `m`), the residual the backward kernels in
// flash_attention_bwd.cu recompute the probabilities from.  With a null
// pointer the kernel does what it did before.

#include <climits>

#include "flash_attention_common.cuh"

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
template <typename E, int D>
__global__ void __launch_bounds__(THREADS, (D <= 64 ? 3 : 1))
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                 const int* __restrict__ seg, E* __restrict__ out, float* __restrict__ lse,
                 int T, int H, float scale, int causal) {
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
  load_tile<E, D, DP>(Qs, q, base, ld, q0, T, tid);
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

    load_tile<E, D, DP>(Ks, k, base, ld, k0, T, tid);
    load_tile<E, D, D>(Vs, v, base, ld, k0, T, tid);
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
        Ps[r * PS + tx + 16 * j] = round_as<E>(p);  // bf16: rounded for p.v only
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
      for (int j = 0; j < CJ; ++j) store_as(out + base + t * ld + tx + 16 * j, acc[i][j] * inv);
      if (lse != nullptr && tx == 0) lse[((long)b * H + h) * T + t] = m[i] + logf(l[i]);
    }
  }
}

template <typename E, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* out,
                   float* lse, int B, int T, int H, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<E, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), seg,
      static_cast<E*>(out), lse, T, H, scale, causal);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* seg,
                     void* out, float* lse, int B, int T, int H, float scale, int causal,
                     cudaStream_t s) {
  switch (D) {
    case 32: return launch<E, 32>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    case 64: return launch<E, 64>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
    case 128: return launch<E, 128>(q, k, v, seg, out, lse, B, T, H, scale, causal, s);
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
  if (bf16)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, seg, out, lse, B, T, H, scale, causal, s);
  return (int)launch_d<float>(D, q, k, v, seg, out, lse, B, T, H, scale, causal, s);
}

extern "C" const char* roar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
