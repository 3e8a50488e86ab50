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
// 256 threads as a 16 x 16 grid.  In the tile products thread (ty, tx) owns
// query rows 4*ty .. 4*ty+3 and key columns tx + 16*j; in the accumulation it
// owns rows 4*ty .. 4*ty+3 of the block's own tile and head-dim columns
// tx + 16*j.  p and dS pass through shared memory between the two.
//
// What bounds it on the H100: the function is five T x T x D products
// (10 B H T^2 D operations); the split into two kernels recomputes q.k^T and
// dout.v^T, so seven are done, all on the FMA pipe with one shared-memory load
// per two FMAs, far above the bytes' time.  What the design does about it:
// the ragged edge is masked in the kernel (T is never padded), and a tile
// whose segment ids all lie outside the block's own [min, max] segment range
// is skipped without being loaded, as in the forward.  With `causal` the
// tiles above the diagonal are skipped too: the dkv kernel's loop over query
// tiles starts at the key tile's own row, the dq kernel's loop over key tiles
// ends at the query tile's own column, and the diagonal tile is masked element
// by element; the dq kernel hands its query tiles out longest first (the dkv
// kernel's first key tile is its longest already).  The bf16 form halves the
// bytes but still multiplies on the FMA pipe: tensor cores and TMA are later
// work.

#include <climits>

#include "flash_attention_common.cuh"

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
// shared memory (Ps may be null when only dS is wanted), each rounded as the
// element type E asks before it enters a product
template <typename E, int D>
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
      if (Ps != nullptr) Ps[r * PS + c] = round_as<E>(p);
      Ss[r * PS + c] = round_as<E>(p * (dp[i][j] - row_delta) * scale);
    }
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                     const int* __restrict__ seg, const float* __restrict__ lse,
                     const float* __restrict__ delta, const E* __restrict__ dout,
                     E* __restrict__ dk, E* __restrict__ dv, int T, int H, float scale,
                     int causal) {
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
  load_tile<E, D, DP>(Ks, k, base, ld, k0, T, tid);
  load_tile<E, D, DP>(Vs, v, base, ld, k0, T, tid);
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

    load_tile<E, D, DP>(Qs, q, base, ld, q0, T, tid);
    load_tile<E, D, DP>(Os, dout, base, ld, q0, T, tid);
    __syncthreads();
    prob_tile<E, D>(Qs, Ks, Vs, Os, segq, segk, lse_s, delta_s, q0, k0, T, scale, causal, ty, tx,
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
        store_as(dk + base + t * ld + tx + 16 * j, acc_dk[i][j]);
        store_as(dv + base + t * ld + tx + 16 * j, acc_dv[i][j]);
      }
    }
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                    const int* __restrict__ seg, const float* __restrict__ lse,
                    const float* __restrict__ delta, const E* __restrict__ dout,
                    E* __restrict__ dq, int T, int H, float scale, int causal) {
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
  load_tile<E, D, DP>(Qs, q, base, ld, q0, T, tid);
  load_tile<E, D, DP>(Os, dout, base, ld, q0, T, tid);
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

    load_tile<E, D, DP>(Ks, k, base, ld, k0, T, tid);
    load_tile<E, D, DP>(Vs, v, base, ld, k0, T, tid);
    __syncthreads();
    prob_tile<E, D>(Qs, Ks, Vs, Os, segq, segk, lse_s, delta_s, q0, k0, T, scale, causal, ty, tx,
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
      for (int j = 0; j < CJ; ++j) store_as(dq + base + t * ld + tx + 16 * j, acc[i][j]);
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

template <typename E, int D>
cudaError_t launch_dkv(const Inputs& in, void* dk, void* dv) {
  constexpr size_t smem = smem_bytes<D>(2);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((in.T + BM - 1) / BM, in.H, in.B);
  flash_bwd_dkv_kernel<E, D><<<grid, THREADS, smem, in.stream>>>(
      static_cast<const E*>(in.q), static_cast<const E*>(in.k), static_cast<const E*>(in.v),
      in.seg, in.lse, in.delta, static_cast<const E*>(in.dout), static_cast<E*>(dk),
      static_cast<E*>(dv), in.T, in.H, in.scale, in.causal);
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t launch_dq(const Inputs& in, void* dq) {
  constexpr size_t smem = smem_bytes<D>(1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((in.T + BM - 1) / BM, in.H, in.B);
  flash_bwd_dq_kernel<E, D><<<grid, THREADS, smem, in.stream>>>(
      static_cast<const E*>(in.q), static_cast<const E*>(in.k), static_cast<const E*>(in.v),
      in.seg, in.lse, in.delta, static_cast<const E*>(in.dout), static_cast<E*>(dq), in.T, in.H,
      in.scale, in.causal);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_dkv_d(int D, const Inputs& in, void* dk, void* dv) {
  switch (D) {
    case 32: return launch_dkv<E, 32>(in, dk, dv);
    case 64: return launch_dkv<E, 64>(in, dk, dv);
    case 128: return launch_dkv<E, 128>(in, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
cudaError_t launch_dq_d(int D, const Inputs& in, void* dq) {
  switch (D) {
    case 32: return launch_dq<E, 32>(in, dq);
    case 64: return launch_dq<E, 64>(in, dq);
    case 128: return launch_dq<E, 128>(in, dq);
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
