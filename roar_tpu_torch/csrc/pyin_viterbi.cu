// K1 and K2: the pYIN HMM's banded Viterbi forward pass and its backtrack.
//
// Replace roar_tpu/ops/pyin_pallas.py `_viterbi_kernel` (K1) and
// `_backtrack_kernel` (K2).  States are [voiced | unvoiced] halves of N pitch
// bins each.  Per frame, for every target bin j of either half:
//
//   u_v = v_voiced - log_norm,  u_u = v_unvoiced - log_norm         (source side)
//   w_same  = max(u_v + log_stay,   u_u + log_switch)                -> voiced targets
//   w_cross = max(u_v + log_switch, u_u + log_stay)                  -> unvoiced targets
//   best[j] = max over o in [0, W) of w[j + o - W/2] + log_tri[o]    (first maximum wins)
//   ptr[j]  = clamp(j + o* - W/2, 0, N-1) + N * (the source came from the unvoiced half)
//   v'[j]   = best[j] + log_obs[t, j]
//
// Only fp32 additions and comparisons, in the order of
// roar_tpu/ops/pyin.py `banded_viterbi_decode`, so decodes are bit-identical
// to it and to the plain PyTorch version.  -1e30 stands for "impossible"
// (never -inf: no NaN from inf - inf).
//
// What bounds it on an H100: neither bytes nor peak arithmetic but the chain
// of T dependent steps.  At B=128, T=449, N=601, W=101 the kernel reads
// 276 MB of observations and writes 276 MB of pointers (0.16 ms at 3.35 TB/s)
// and does about 1.4e10 add/compare operations (0.2 ms at 67 TFLOP/s fp32),
// but every frame needs the one before it.  The design keeps the whole
// recursion in ONE launch: one thread block per utterance, the two score rows
// in shared memory with -1e30 halos of W/2 (so the band needs no bounds
// test), one thread per pitch bin carrying both of its scores in registers,
// two block barriers per frame, the next frame's observations loaded before
// the band loop so their latency hides behind it, and pointers written
// straight to global memory.  Spreading one utterance over several SMs
// (clusters), async prefetch and fusing the backtrack are later work.
//
// K2 walks the pointers back, one thread per utterance: T dependent 4-byte
// loads each, latency-bound by construction.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;

__global__ void pyin_viterbi_fwd_kernel(
    const float* __restrict__ obs,       // [B, T, 2N]
    const float* __restrict__ log_tri,   // [W]
    const float* __restrict__ log_norm,  // [N]
    int* __restrict__ ptr,               // [B, T, 2N]; row 0 is written as 0
    float* __restrict__ v_final,         // [B, 2N]
    int T, int N, int W, float log_stay, float log_switch, float log_init_u) {
  extern __shared__ float smem[];
  const int half = W / 2;
  const int padded = N + 2 * half;
  float* w_same = smem;                   // [padded]
  float* w_cross = w_same + padded;       // [padded]
  float* tri = w_cross + padded;          // [W]
  unsigned char* sel_same = reinterpret_cast<unsigned char*>(tri + W);  // [N]
  unsigned char* sel_cross = sel_same + N;                              // [N]

  const int j = threadIdx.x;
  const bool active = j < N;
  const size_t row = 2 * static_cast<size_t>(N);
  const float* obs_b = obs + static_cast<size_t>(blockIdx.x) * T * row;
  int* ptr_b = ptr + static_cast<size_t>(blockIdx.x) * T * row;

  for (int i = j; i < padded; i += blockDim.x) {
    w_same[i] = kNeg;   // the halos stay -1e30 for the whole launch
    w_cross[i] = kNeg;
  }
  for (int i = j; i < W; i += blockDim.x) tri[i] = log_tri[i];

  // v0 = p_init + obs[0]: voiced states impossible, unvoiced uniform
  float vv = kNeg, vu = kNeg, norm = 0.0f;
  if (active) {
    norm = log_norm[j];
    vv = kNeg + obs_b[j];
    vu = log_init_u + obs_b[N + j];
    ptr_b[j] = 0;
    ptr_b[N + j] = 0;
  }

  for (int t = 1; t < T; ++t) {
    float obs_v = 0.0f, obs_u = 0.0f;
    if (active) {
      obs_v = obs_b[t * row + j];  // used after the band loop
      obs_u = obs_b[t * row + N + j];
      const float u_v = vv - norm;
      const float u_u = vu - norm;
      const float stay_v = u_v + log_stay, switch_u = u_u + log_switch;
      const float switch_v = u_v + log_switch, stay_u = u_u + log_stay;
      w_same[half + j] = fmaxf(stay_v, switch_u);
      sel_same[j] = switch_u > stay_v;
      w_cross[half + j] = fmaxf(switch_v, stay_u);
      sel_cross[j] = stay_u > switch_v;
    }
    __syncthreads();
    if (active) {
      float best_v = kNeg, best_u = kNeg;
      int off_v = 0, off_u = 0;
      for (int o = 0; o < W; ++o) {  // ascending, strict >: the first maximum wins
        const float w = tri[o];
        const float cand_v = w_same[j + o] + w;
        const float cand_u = w_cross[j + o] + w;
        if (cand_v > best_v) { best_v = cand_v; off_v = o; }
        if (cand_u > best_u) { best_u = cand_u; off_u = o; }
      }
      const int src_v = min(max(j - half + off_v, 0), N - 1);
      const int src_u = min(max(j - half + off_u, 0), N - 1);
      ptr_b[t * row + j] = src_v + (sel_same[src_v] ? N : 0);
      ptr_b[t * row + N + j] = src_u + (sel_cross[src_u] ? N : 0);
      vv = best_v + obs_v;
      vu = best_u + obs_u;
    }
    __syncthreads();  // all reads of this frame's rows are done
  }

  if (active) {
    v_final[blockIdx.x * row + j] = vv;
    v_final[blockIdx.x * row + N + j] = vu;
  }
}

__global__ void pyin_backtrack_kernel(
    const int* __restrict__ ptr,   // [B, T, S]
    const int* __restrict__ last,  // [B]
    int* __restrict__ states,      // [B, T]
    int B, int T, int S) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* ptr_b = ptr + static_cast<size_t>(b) * T * S;
  int* out = states + static_cast<size_t>(b) * T;
  int state = last[b];
  out[T - 1] = state;
  for (int t = T - 1; t >= 1; --t) {
    state = ptr_b[static_cast<size_t>(t) * S + state];
    out[t - 1] = state;
  }
}

}  // namespace

// Bytes of dynamic shared memory the forward kernel needs.
static size_t viterbi_smem_bytes(int N, int W) {
  const int padded = N + 2 * (W / 2);
  return sizeof(float) * (2 * padded + W) + 2 * static_cast<size_t>(N);
}

// One block per utterance, one thread per pitch bin (N <= 1024).  Returns the
// CUDA error of the launch (0 on success); 1 (cudaErrorInvalidValue) for
// sizes the kernel does not take.
extern "C" int roar_pyin_viterbi_fwd(
    const void* obs, const void* log_tri, const void* log_norm, void* ptr, void* v_final,
    int B, int T, int N, int W, float log_stay, float log_switch, float log_init_u,
    void* stream) {
  if (B < 1 || T < 1 || N < 1 || N > 1024 || W < 1 || W % 2 == 0) return cudaErrorInvalidValue;
  const size_t smem = viterbi_smem_bytes(N, W);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pyin_viterbi_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = ((N + 31) / 32) * 32;
  pyin_viterbi_fwd_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs), static_cast<const float*>(log_tri),
      static_cast<const float*>(log_norm), static_cast<int*>(ptr),
      static_cast<float*>(v_final), T, N, W, log_stay, log_switch, log_init_u);
  return cudaGetLastError();
}

// One thread per utterance.  S is the number of states (2N).
extern "C" int roar_pyin_backtrack(
    const void* ptr, const void* last, void* states, int B, int T, int S, void* stream) {
  if (B < 1 || T < 1 || S < 1) return cudaErrorInvalidValue;
  const int threads = 32;
  pyin_backtrack_kernel<<<(B + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(last),
      static_cast<int*>(states), B, T, S);
  return cudaGetLastError();
}
