// Segment-masked flash-attention forward, fp32, for Hopper (sm_90a).
//
// Replaces: the upstream Pallas TPU kernel
// `jax.experimental.pallas.ops.tpu.flash_attention` (non-causal, SegmentIds)
// that roar_tpu/models/transformer.py:72 `flash_self_attention` reaches.
// Query i sees key j only when seg[b, i] == seg[b, j]; the FastPitch stacks
// give valid tokens id 0 and padding id 1, so pad queries see only pad keys.
//
// Layout: q, k, v, out are contiguous [B, T, H, D] fp32; seg is [B, T] int32.
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
// bucket is padding, about half the passes.  Tensor cores (wgmma), TMA and
// bf16 are later work.
//
// Training: when the caller passes `lse`, each in-range row also writes its
// log-sum-exp `m + log l` to lse[B, H, T] (one tensor in place of the TPU
// kernel's lane-broadcast `l` and `m`), the residual the backward kernels in
// flash_attention_bwd.cu recompute the probabilities from.  With a null
// pointer the kernel does what it did before.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PS = BK + 1;    // padded row stride of the P tile

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS) +
         sizeof(int) * (BQ + BK);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ out, float* __restrict__ lse, int T, int H,
                 float scale) {
  constexpr int DP = D + 1;   // padded row stride of the Q and K tiles
  constexpr int CJ = D / 16;  // output columns per thread
  constexpr int D4 = D / 4;   // float4s per row

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
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long ld = (long)H * D;  // elements between consecutive t
  const long base = (long)b * T * ld + (long)h * D;
  const int* segb = seg + (long)b * T;

  if (tid == 0) {
    qlo = INT_MAX;
    qhi = INT_MIN;
  }
  for (int i = tid; i < BQ * D4; i += THREADS) {
    const int r = i / D4, c = (i % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) x = *reinterpret_cast<const float4*>(q + base + (q0 + r) * ld + c);
    float* dst = Qs + r * DP + c;
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }
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

  for (int k0 = 0; k0 < T; k0 += BK) {
    // Every read of the previous tile's segk finished before the barrier
    // that followed its P tile; this barrier also ends its reads of Vs/Ps.
    bool seen = false;
    if (tid < BK) {
      const int s = (k0 + tid < T) ? segb[k0 + tid] : 0;
      segk[tid] = s;
      seen = (k0 + tid < T) && s >= qlo && s <= qhi;
    }
    if (!__syncthreads_or(seen)) continue;

    for (int i = tid; i < BK * D4; i += THREADS) {
      const int r = i / D4, c = (i % D4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < T) {
        kx = *reinterpret_cast<const float4*>(k + base + (k0 + r) * ld + c);
        vx = *reinterpret_cast<const float4*>(v + base + (k0 + r) * ld + c);
      }
      float* kd = Ks + r * DP + c;
      kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
      *reinterpret_cast<float4*>(Vs + r * D + c) = vx;
    }
    __syncthreads();

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
        const bool ok = (k0 + c < T) && segk[c] == sq;
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
cudaError_t launch(const float* q, const float* k, const float* v, const int* seg,
                   float* out, float* lse, int B, int T, int H, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, seg, out, lse, T, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int roar_flash_attention_fwd(const float* q, const float* k, const float* v,
                                        const int* seg, float* out, float* lse, int B, int T,
                                        int H, int D, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch<32>(q, k, v, seg, out, lse, B, T, H, scale, s);
    case 64: return (int)launch<64>(q, k, v, seg, out, lse, B, T, H, scale, s);
    case 128: return (int)launch<128>(q, k, v, seg, out, lse, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* roar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
