// Segment-masked flash-attention backward, fp32, for Hopper (sm_90a).
//
// Replaces: the two upstream Pallas TPU kernels `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq` of `jax.experimental.pallas.ops.tpu.flash_attention`
// that the custom VJP of `flash_attention` launches (non-causal, SegmentIds),
// reached in training from roar_tpu/models/transformer.py:110.
//
// Layout: q, k, v, dout, dq, dk, dv are contiguous [B, T, H, D] fp32; seg is
// [B, T] int32; lse (the forward's `m + log l`) and delta (`sum(o * dout, -1)`)
// are [B, H, T] fp32.  Both kernels recompute, per 64 x 64 tile,
//   p  = exp(q.k * scale - lse)   where the two segment ids agree, else 0
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
// is skipped without being loaded, as in the forward.  Tensor cores, TMA and
// bf16 are later work.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int BM = 64;        // tile rows (queries) and columns (keys)
constexpr int THREADS = 256;  // 16 x 16
constexpr int PS = BM + 1;    // padded row stride of the p and dS tiles

template <int D>
constexpr size_t smem_bytes(int n_prob_tiles) {
  return sizeof(float) * (4 * BM * (D + 1) + n_prob_tiles * BM * PS + 2 * BM) +
         sizeof(int) * (2 * BM);
}

// rows r0 .. r0+63 of x[b, :, h, :] into dst[BM][D + 1]; rows past T are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ x, long base,
                                          long ld, int r0, int T, int tid) {
  constexpr int DP = D + 1, D4 = D / 4;
  for (int i = tid; i < BM * D4; i += THREADS) {
    const int r = i / D4, c = (i % D4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) val = *reinterpret_cast<const float4*>(x + base + (long)(r0 + r) * ld + c);
    float* d = dst + r * DP + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
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
                                          int k0, int T, float scale, int ty, int tx,
                                          float* Ps, float* Ss) {
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
      const bool ok = (q0 + r < T) && (k0 + c < T) && segk[c] == sq;
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
                     float* __restrict__ dv, int T, int H, float scale) {
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
  load_tile<D>(Ks, k, base, ld, k0, T, tid);
  load_tile<D>(Vs, v, base, ld, k0, T, tid);
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

  for (int q0 = 0; q0 < T; q0 += BM) {
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

    load_tile<D>(Qs, q, base, ld, q0, T, tid);
    load_tile<D>(Os, dout, base, ld, q0, T, tid);
    __syncthreads();
    prob_tile<D>(Qs, Ks, Vs, Os, segq, segk, lse_s, delta_s, q0, k0, T, scale, ty, tx, Ps, Ss);
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
                    float scale) {
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
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;
  const long row_base = ((long)b * H + h) * T;

  if (tid == 0) {
    qlo = INT_MAX;
    qhi = INT_MIN;
  }
  load_tile<D>(Qs, q, base, ld, q0, T, tid);
  load_tile<D>(Os, dout, base, ld, q0, T, tid);
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

  for (int k0 = 0; k0 < T; k0 += BM) {
    // segk of the previous tile was last read before the barrier that
    // followed its dS tile; the barrier below also ends its reads of Ks and Ss.
    bool seen = false;
    if (tid < BM) {
      const int s = (k0 + tid < T) ? segb[k0 + tid] : 0;
      segk[tid] = s;
      seen = (k0 + tid < T) && s >= qlo && s <= qhi;
    }
    if (!__syncthreads_or(seen)) continue;

    load_tile<D>(Ks, k, base, ld, k0, T, tid);
    load_tile<D>(Vs, v, base, ld, k0, T, tid);
    __syncthreads();
    prob_tile<D>(Qs, Ks, Vs, Os, segq, segk, lse_s, delta_s, q0, k0, T, scale, ty, tx, nullptr,
                 Ss);
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

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const int* seg,
                       const float* lse, const float* delta, const float* dout, float* dk,
                       float* dv, int B, int T, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>(2);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BM - 1) / BM, H, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, seg, lse, delta, dout, dk,
                                                           dv, T, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const int* seg,
                      const float* lse, const float* delta, const float* dout, float* dq, int B,
                      int T, int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>(1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BM - 1) / BM, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, seg, lse, delta, dout, dq, T,
                                                          H, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int H) {
  return B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace

extern "C" int roar_flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                            const int* seg, const float* lse,
                                            const float* delta, const float* dout, float* dk,
                                            float* dv, int B, int T, int H, int D, float scale,
                                            void* stream) {
  if (bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_dkv<32>(q, k, v, seg, lse, delta, dout, dk, dv, B, T, H, scale, s);
    case 64: return (int)launch_dkv<64>(q, k, v, seg, lse, delta, dout, dk, dv, B, T, H, scale, s);
    case 128:
      return (int)launch_dkv<128>(q, k, v, seg, lse, delta, dout, dk, dv, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int roar_flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                           const int* seg, const float* lse, const float* delta,
                                           const float* dout, float* dq, int B, int T, int H,
                                           int D, float scale, void* stream) {
  if (bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_dq<32>(q, k, v, seg, lse, delta, dout, dq, B, T, H, scale, s);
    case 64: return (int)launch_dq<64>(q, k, v, seg, lse, delta, dout, dq, B, T, H, scale, s);
    case 128: return (int)launch_dq<128>(q, k, v, seg, lse, delta, dout, dq, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
