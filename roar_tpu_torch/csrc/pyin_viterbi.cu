// K1 and K2: the pYIN HMM's banded Viterbi forward pass and its backtrack,
// designed for Hopper (sm_90a).
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
// What bounds K1 on an H100: neither bytes nor peak arithmetic but the chain
// of T dependent frames.  At (B, T, N, W) = (16, 449, 601, 101) it reads and
// writes 69 MB and does 1.8e9 adds and compares (27 us at 67 TFLOP/s fp32);
// one block per utterance kept 16 of 132 SMs busy, each frame issue-bound on
// one SM (4 us a frame).  Within a frame the band's compares and selects run
// on the ALU pipe at half the FP32 rate (three of them a candidate), and the
// frame ends at a barrier.  The design, per frame: the band of one utterance
// spread over a cluster, a short chain per lane, no cluster-scope fence.
//
// - One cluster of C blocks per utterance; block r owns bins [r S, r S + S),
//   S = ceil(N / C), of both halves.  C is the largest of 8, 4, 2, 1 with
//   B C <= the SM count and S >= W/2 (so a halo comes from the immediate
//   neighbours only); 8 is the portable cluster limit.  The rule lives in
//   kernels/pyin_viterbi.py `cluster_size`; the launch function refuses a C
//   the shape does not admit, and a launch the card refuses returns its error.
// - Each block keeps its rows in shared memory, double-buffered by frame
//   parity: (w_same, w_cross) as float2 and the two source-half selectors as
//   the bits of a word, for its bins and a W/2 halo on each side, -1e30 where
//   no bin is.  The owner of a bin writes its own entry and pushes the
//   entries of its W/2 edge bins, values and selector bits (a clamped source
//   bin may lie in a neighbour's range), into the halos of the left and right
//   neighbours by st.async, whose bytes complete on the receiving block's
//   mbarrier for that parity.  A frame then needs one block barrier (the
//   block's own entries) and a wait on that mbarrier (the halo): no cluster
//   barrier, whose release semantics cost about 0.4 us a frame on this card
//   (a diagnostic build, PERF.md).  Why double buffering is enough: a block
//   pushes frame t into buffer t&1 only after it has received its
//   neighbours' frame t-1 pushes, which they send only after their frame t-2
//   band, the last reads of buffer t&1; and a frame's bytes never reach an
//   mbarrier before its frame t-2 phase has completed, for the same reason.
//   A launch starts with a cluster barrier (mbarriers ready, -1e30 halos
//   written) and ends with one, so no block exits while a neighbour may still
//   reach its shared memory.  C = 1 has no neighbour: the block barrier serves.
// - The band max of a bin is split over P lanes of one warp, P the largest of
//   8, 4, 2 with S P <= kThreadTarget threads, else 1 (`pick_lanes`), each
//   over a contiguous sub-range of L = ceil(W/P) offsets (offsets past W weigh
//   -1e30 and never win), a running strict > from -1e30 each; the P partials
//   are combined by warp shuffles: the larger value wins, on equal values the
//   lower offset, and a bin whose best never exceeds -1e30 keeps -1e30 and
//   offset 0 - the plain version's rule.  Row entries are loaded kDepth ahead
//   of their use.
// - log_tri is in constant memory; at W = 101 (the production width, its own
//   template instance) the offset loop is unrolled, so with P = 1 each weight
//   is a constant operand of the add, and with P > 1 each lane holds its
//   sub-range's weights in registers: one add, no shared load either way.  The
//   generic W instance reads the weights from constant memory.
// - Observations are loaded two frames ahead of their use, into registers.
//   Pointers are int32 stores straight to global memory.
// No atomics; every run gives the same bits.
//
// K2 walks the pointers back, one block per utterance and one thread on the
// chain: state[t-1] = ptr[t][state[t]] for t = T-1 .. 1; 448 dependent
// 4-byte loads from device memory took 0.2 us each.  Here rows t-1, t-2, ...
// stream into a ring of shared-memory slots ahead of the chain, G rows a slot
// (about 16 KB), copied by kCopyWarps warps with 16-byte cp.async (a slot's
// `full` mbarrier completes when every copying lane's copies land; its
// `empty` one when the chain has read it), so a step of the chain is a
// shared-memory load.  What bounds it then is how fast one SM takes in the
// rows: 2.15 MB an utterance at (T, N) = (449, 601).  A row is 2N * 4 bytes
// (4808 at N 601), so a group of rows starts off a 16-byte boundary half the
// time: each copy takes the 16-byte-aligned window around the rows (it never
// leaves the 16-byte blocks, hence the pages, the rows lie in) and the chain
// indexes with the window's offset.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxW = 2047;         // log_tri's room in constant memory
constexpr int kMaxBins = 1024;      // N
constexpr int kThreadTarget = 320;  // threads a forward block aims at
constexpr int kDepth = 8;           // row entries a lane loads ahead of their use
constexpr int kProductionW = 101;   // configs/ds_for_fastpitch_align.yaml

__constant__ float c_log_tri[kMaxW];

struct FwdParams {
  const float* obs;       // [B, T, 2N]
  const float* log_norm;  // [N]
  int* ptr;               // [B, T, 2N]; row 0 is written as 0
  float* v_final;         // [B, 2N]
  int T, N, W;
  int S;                  // bins a block owns: ceil(N / C)
  int C;                  // blocks per cluster, one cluster per utterance
  float log_stay, log_switch, log_init_u;
};

// Where a forward block keeps its shared state (byte offsets).
struct FwdLayout {
  int row_len;  // row entries: the block's bins, a W/2 halo each side, offsets past W
  int threads;
  size_t bars, rows, sels, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int S, int W, int P) {
  FwdLayout l;
  const int L = (W + P - 1) / P;
  l.row_len = S + P * L - 1;
  l.threads = (S * P + 31) / 32 * 32;
  l.bars = 0;                                             // uint64 [2]: halo arrivals by parity
  l.rows = 16;                                            // float2 [2][row_len]: (w_same, w_cross)
  l.sels = l.rows + 16 * static_cast<size_t>(l.row_len);  // uint32 [2][row_len]: selector bits
  l.bytes = l.sels + 8 * static_cast<size_t>(l.row_len);
  return l;
}

__device__ __forceinline__ uint32_t shared_address(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// The address of the same shared-memory location in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_address(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// A row entry and its selector bits into a neighbour's halo; the bytes count
// against that neighbour's halo mbarrier when they land.
__device__ __forceinline__ void push_entry(uint32_t row_at, uint32_t sel_at, uint32_t bar,
                                           float2 w, uint32_t s) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          row_at),
      "f"(w.x), "f"(w.y), "r"(bar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   sel_at),
               "r"(s), "r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Keep the better of this lane's (best, off) and that of the lane `mask`
// away: the larger value, on equal values the lower offset.
__device__ __forceinline__ void take_better(float& best, int& off, int mask) {
  const float other = __shfl_xor_sync(0xffffffffu, best, mask);
  const int other_off = __shfl_xor_sync(0xffffffffu, off, mask);
  if (other > best || (other == best && other_off < off)) {
    best = other;
    off = other_off;
  }
}

// One running strict > step of a candidate pair.
__device__ __forceinline__ void band_step(float2 x, float w, int q, float& bv, int& qv,
                                          float& bu, int& qu) {
  const float cv = x.x + w, cu = x.y + w;
  if (cv > bv) { bv = cv; qv = q; }
  if (cu > bu) { bu = cu; qu = q; }
}

// kW: the band width, or 0 for W at run time.  P: lanes per bin (a power of
// two up to 8), each over L = ceil(W/P) offsets.
template <int kW, int P>
__global__ void __launch_bounds__(P > 1 ? kThreadTarget : 1024)
    pyin_viterbi_fwd_kernel(const FwdParams p) {
  static_assert(P >= 1 && P <= 8 && (P & (P - 1)) == 0, "P is 1, 2, 4 or 8");
  constexpr int kL = kW > 0 ? (kW + P - 1) / P : 1;
  constexpr bool kTriInRegisters = kW > 0 && P > 1;
  const int W = kW > 0 ? kW : p.W;
  const int L = kW > 0 ? kL : (W + P - 1) / P;
  const int half = W / 2;
  const int N = p.N, S = p.S, C = p.C, T = p.T;
  const FwdLayout lay = fwd_layout(S, W, P);
  const int row_len = lay.row_len;

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  float2* rows = reinterpret_cast<float2*>(smem + lay.rows);
  uint32_t* sels = reinterpret_cast<uint32_t*>(smem + lay.sels);

  const int rank = C > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int b = blockIdx.x / C;
  const int lo = min(rank * S, N);  // first bin of this block
  const int nb = min(S, N - lo);    // bins it owns
  const int base = lo - half;       // the bin at row index 0
  const int bin_lane = threadIdx.x / P, sub = threadIdx.x % P;
  // lanes past the last bin repeat its band work (whole shuffle groups) and
  // store nothing
  const int g = min(bin_lane, S - 1), j = lo + g;
  const bool mine = sub == 0 && bin_lane < nb;

  for (int i = threadIdx.x; i < 2 * row_len; i += blockDim.x) {
    rows[i] = make_float2(kNeg, kNeg);  // halos outside [0, N) stay -1e30
    sels[i] = 0;
  }
  if (threadIdx.x == 0 && C > 1) {
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(bars + s))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float tri[kTriInRegisters ? kL : 1];
  if constexpr (kTriInRegisters) {
#pragma unroll
    for (int q = 0; q < kL; ++q) {
      const int o = sub * kL + q;
      tri[q] = o < kW ? c_log_tri[o] : kNeg;
    }
  }
  // the neighbours' rows, selectors and halo mbarriers; the bytes a frame
  // brings into this block's halos (the left neighbour pushes its bins past
  // S - W/2, the right one its first W/2; either may own fewer bins than S
  // at the end of the range)
  const bool has_left = C > 1 && rank > 0, has_right = C > 1 && rank < C - 1;
  uint32_t left_rows = 0, left_sels = 0, left_bars = 0;
  uint32_t right_rows = 0, right_sels = 0, right_bars = 0;
  if (has_left) {
    left_rows = cluster_address(shared_address(rows), rank - 1);
    left_sels = cluster_address(shared_address(sels), rank - 1);
    left_bars = cluster_address(shared_address(bars), rank - 1);
  }
  if (has_right) {
    right_rows = cluster_address(shared_address(rows), rank + 1);
    right_sels = cluster_address(shared_address(sels), rank + 1);
    right_bars = cluster_address(shared_address(bars), rank + 1);
  }
  const int left_bins = has_left ? max(0, min(S, N - (rank - 1) * S)) : 0;
  const int right_bins = has_right ? max(0, min(S, N - (rank + 1) * S)) : 0;
  const uint32_t halo_bytes = static_cast<uint32_t>(
      (sizeof(float2) + sizeof(uint32_t)) *
      (max(0, left_bins - (S - half)) + min(half, right_bins)));

  const size_t row = 2 * static_cast<size_t>(N);
  const float* obs_b = p.obs + static_cast<size_t>(b) * T * row;
  int* ptr_b = p.ptr + static_cast<size_t>(b) * T * row;

  // v0 = p_init + obs[0]: voiced states impossible, unvoiced uniform; the
  // observations of frames 1 and 2 on their way
  float vv = kNeg, vu = kNeg, norm = 0.0f, next_v[2] = {0.0f, 0.0f}, next_u[2] = {0.0f, 0.0f};
  if (mine) {
    norm = p.log_norm[j];
    vv = kNeg + obs_b[j];
    vu = p.log_init_u + obs_b[N + j];
    ptr_b[j] = 0;
    ptr_b[N + j] = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (1 + u < T) {
        next_v[u] = obs_b[(1 + u) * row + j];
        next_u[u] = obs_b[(1 + u) * row + N + j];
      }
    }
  }
  // every block's halos -1e30 and mbarriers ready before any push
  if (C > 1) {
    cluster_sync_all();
  } else {
    __syncthreads();
  }

  for (int t0 = 1; t0 < T; t0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // two frames a trip: the observation registers alternate
      const int t = t0 + u;
      if (t >= T) break;
      const int par = t & 1, buf = par * row_len;
      float2* rw = rows + buf;
      uint32_t* sl = sels + buf;
      if (threadIdx.x == 0 && C > 1) {  // this frame's halo bytes, whenever they land
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         shared_address(bars + par)),
                     "r"(halo_bytes) : "memory");
      }

      // this block's row entry from v_{t-1}, and the edges to the neighbours
      if (mine) {
        const int x = g + half;
        const float u_v = vv - norm;
        const float u_u = vu - norm;
        const float stay_v = u_v + p.log_stay, switch_u = u_u + p.log_switch;
        const float switch_v = u_v + p.log_switch, stay_u = u_u + p.log_stay;
        const float2 w = make_float2(fmaxf(stay_v, switch_u), fmaxf(switch_v, stay_u));
        const uint32_t s = (switch_u > stay_v ? 1u : 0u) | (stay_u > switch_v ? 2u : 0u);
        rw[x] = w;
        sl[x] = s;
        if (has_left && g < half) {  // the left neighbour's right halo
          const int at = buf + x + S;
          push_entry(left_rows + sizeof(float2) * at, left_sels + sizeof(uint32_t) * at,
                     left_bars + sizeof(uint64_t) * par, w, s);
        }
        if (has_right && g >= S - half) {  // the right neighbour's left halo
          const int at = buf + x - S;
          push_entry(right_rows + sizeof(float2) * at, right_sels + sizeof(uint32_t) * at,
                     right_bars + sizeof(uint64_t) * par, w, s);
        }
      }
      __syncthreads();
      if (C > 1) wait_parity(shared_address(bars + par), static_cast<uint32_t>(((t - 1) >> 1) & 1));

      // the band max over this lane's sub-range, ascending, strict >
      float bv = kNeg, bu = kNeg;
      int qv = 0, qu = 0;
      const float2* src = rw + g + sub * L;  // row index of bin g, offset sub * L
      if constexpr (kW > 0) {
        // row entries loaded eight ahead of their use, to keep loads in flight
#pragma unroll
        for (int q0 = 0; q0 < kL; q0 += kDepth) {
          float2 xs[kDepth];
#pragma unroll
          for (int i = 0; i < kDepth; ++i) {
            if (q0 + i < kL) xs[i] = src[q0 + i];
          }
#pragma unroll
          for (int i = 0; i < kDepth; ++i) {
            const int q = q0 + i;
            if (q >= kL) continue;
            float w;
            if constexpr (kTriInRegisters) {
              w = tri[q];
            } else {
              w = c_log_tri[q];
            }
            band_step(xs[i], w, q, bv, qv, bu, qu);
          }
        }
      } else {
        for (int q = 0; q < L; ++q) {
          const int o = sub * L + q;
          band_step(src[q], o < W ? c_log_tri[o] : kNeg, q, bv, qv, bu, qu);
        }
      }
      // the partials' offsets (0 where the best never exceeded -1e30), combined
      int ov = bv > kNeg ? sub * L + qv : 0;
      int ou = bu > kNeg ? sub * L + qu : 0;
#pragma unroll
      for (int m = 1; m < P; m <<= 1) {
        take_better(bv, ov, m);
        take_better(bu, ou, m);
      }

      // pointers, with the source half read at the clamped source bin
      if (mine) {
        const int src_v = min(max(j - half + ov, 0), N - 1);
        const int src_u = min(max(j - half + ou, 0), N - 1);
        int* out = ptr_b + t * row;
        out[j] = src_v + ((sl[src_v - base] & 1u) ? N : 0);
        out[N + j] = src_u + ((sl[src_u - base] & 2u) ? N : 0);
        vv = bv + next_v[u];
        vu = bu + next_u[u];
        if (t + 2 < T) {
          next_v[u] = obs_b[(t + 2) * row + j];
          next_u[u] = obs_b[(t + 2) * row + N + j];
        }
      }
    }
  }
  // no block leaves while a neighbour may still reach its shared memory
  if (C > 1) cluster_sync_all();

  if (mine) {
    p.v_final[b * row + j] = vv;
    p.v_final[b * row + N + j] = vu;
  }
}

// Rows [lo, hi] of chunk c (rows T-1 .. 1 walked down, G a chunk).
__device__ __forceinline__ void chunk_rows(int c, int T, int G, int& lo, int& hi) {
  hi = T - 1 - c * G;
  lo = max(1, hi - G + 1);
}

constexpr int kCopyWarps = 3;  // K2: warps that stream rows, beside the chain's warp

// One block per utterance: lane 0 of warp 0 follows the chain, warps 1 to
// kCopyWarps copy chunks of rows into the ring by 16-byte cp.async.  Slot s
// has a `full` mbarrier (one arrival a copying lane, when its copies land)
// and an `empty` one (the chain's arrival when it has read the slot).
__global__ void __launch_bounds__(32 * (1 + kCopyWarps)) pyin_backtrack_kernel(
    const int* __restrict__ ptr,   // [B, T, S]
    const int* __restrict__ last,  // [B]
    int* __restrict__ states,      // [B, T]
    int T, int S, int G, int R, int slot_ints) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [R]
  uint64_t* empty = full + R;                          // [R]
  int* ring = reinterpret_cast<int*>(smem + 16 * ((16 * R + 15) / 16));  // [R][slot_ints]
  const int* ptr_b = ptr + static_cast<size_t>(blockIdx.x) * T * S;
  int* out = states + static_cast<size_t>(blockIdx.x) * T;
  const int chunks = (T - 1 + G - 1) / G;
  if (threadIdx.x == 0) {
    out[T - 1] = last[blockIdx.x];
    for (int s = 0; s < R; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(full + s)),
                   "r"(32 * kCopyWarps) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(empty + s))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (chunks == 0) return;

  if (threadIdx.x >= 32) {  // copying
    const int lane = threadIdx.x - 32;
    for (int c = 0; c < chunks; ++c) {
      const int slot = c % R;
      if (c >= R) wait_parity(shared_address(empty + slot), static_cast<uint32_t>((c / R - 1) & 1));
      // the 16-byte-aligned window around chunk c's rows: it never leaves
      // the 16-byte blocks (hence the pages) the rows lie in
      int lo, hi;
      chunk_rows(c, T, G, lo, hi);
      const uintptr_t first = reinterpret_cast<uintptr_t>(ptr_b + static_cast<size_t>(lo) * S);
      const uintptr_t end = reinterpret_cast<uintptr_t>(ptr_b + static_cast<size_t>(hi + 1) * S);
      const uintptr_t start = first & ~static_cast<uintptr_t>(15);
      const int segments =
          static_cast<int>((((end + 15) & ~static_cast<uintptr_t>(15)) - start) / 16);
      const uint32_t dst = shared_address(ring + static_cast<size_t>(slot) * slot_ints);
      for (int i = lane; i < segments; i += 32 * kCopyWarps) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * i),
                     "l"(start + 16 * static_cast<uintptr_t>(i)) : "memory");
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                       shared_address(full + slot)) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  if (threadIdx.x != 0) return;
  int state = last[blockIdx.x];
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % R;
    wait_parity(shared_address(full + slot), static_cast<uint32_t>((c / R) & 1));
    int lo, hi;
    chunk_rows(c, T, G, lo, hi);
    const uintptr_t first = reinterpret_cast<uintptr_t>(ptr_b + static_cast<size_t>(lo) * S);
    const int* rows = ring + static_cast<size_t>(slot) * slot_ints + (first & 15) / 4;
    for (int r = hi; r >= lo; --r) {
      state = rows[(r - lo) * S + state];
      out[r - 1] = state;
    }
    // release: the reads above come before the copies that refill the slot
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_address(empty + slot))
                 : "memory");
  }
}

// Lanes a bin: P, the largest of 8, 4, 2 with S P <= kThreadTarget threads,
// else 1.
int pick_lanes(int S) {
  for (int P = 8; P > 1; P /= 2) {
    if (S * P <= kThreadTarget) return P;
  }
  return 1;
}

// Launch (or, with `max_clusters`, ask the occupancy calculator about) one
// instance of the forward kernel.
template <int kW, int P>
cudaError_t launch_fwd(const FwdParams& prm, int B, cudaStream_t stream, int* max_clusters) {
  auto kernel = pyin_viterbi_fwd_kernel<kW, P>;
  const FwdLayout lay = fwd_layout(prm.S, prm.W, P);
  if (lay.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(lay.bytes));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = prm.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * prm.C);
  cfg.blockDim = dim3(lay.threads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, prm);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kW>
cudaError_t dispatch_lanes(const FwdParams& prm, int B, cudaStream_t stream, int* max_clusters) {
  switch (pick_lanes(prm.S)) {
    case 8: return launch_fwd<kW, 8>(prm, B, stream, max_clusters);
    case 4: return launch_fwd<kW, 4>(prm, B, stream, max_clusters);
    case 2: return launch_fwd<kW, 2>(prm, B, stream, max_clusters);
    default: return launch_fwd<kW, 1>(prm, B, stream, max_clusters);
  }
}

cudaError_t dispatch_fwd(const FwdParams& prm, int B, cudaStream_t stream, int* max_clusters) {
  return prm.W == kProductionW ? dispatch_lanes<kProductionW>(prm, B, stream, max_clusters)
                               : dispatch_lanes<0>(prm, B, stream, max_clusters);
}

// C in {1, 2, 4, 8} and, for C > 1, ceil(N / C) >= W / 2.
bool cluster_admissible(int N, int W, int C) {
  if (C != 1 && C != 2 && C != 4 && C != 8) return false;
  return C == 1 || (N + C - 1) / C >= W / 2;
}

bool fwd_sizes_ok(int B, int N, int W, int C) {
  return B >= 1 && N >= 1 && N <= kMaxBins && W >= 1 && W <= kMaxW && W % 2 == 1 &&
         cluster_admissible(N, W, C);
}

}  // namespace

// One cluster of C blocks per utterance (C chosen by the caller, see
// kernels/pyin_viterbi.py `cluster_size`).  Returns the CUDA error of the
// launch (0 on success); 1 (cudaErrorInvalidValue) for sizes the kernel does
// not take.  log_tri is copied into constant memory on `stream` first, so
// two launches with different band weights must not overlap on two streams.
extern "C" int roar_pyin_viterbi_fwd(
    const void* obs, const void* log_tri, const void* log_norm, void* ptr, void* v_final,
    int B, int T, int N, int W, int C, float log_stay, float log_switch, float log_init_u,
    void* stream) {
  if (T < 1 || !fwd_sizes_ok(B, N, W, C)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyToSymbolAsync(c_log_tri, log_tri, sizeof(float) * W, 0,
                                            cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  FwdParams prm{static_cast<const float*>(obs), static_cast<const float*>(log_norm),
                static_cast<int*>(ptr), static_cast<float*>(v_final), T, N, W,
                (N + C - 1) / C, C, log_stay, log_switch, log_init_u};
  return dispatch_fwd(prm, B, s, nullptr);
}

// cudaOccupancyMaxActiveClusters for the forward launch at (B, N, W, C),
// written to *out.
extern "C" int roar_pyin_viterbi_max_active_clusters(int B, int N, int W, int C, int* out) {
  if (!fwd_sizes_ok(B, N, W, C)) return cudaErrorInvalidValue;
  FwdParams prm{};
  prm.N = N;
  prm.W = W;
  prm.S = (N + C - 1) / C;
  prm.C = C;
  return dispatch_fwd(prm, B, nullptr, out);
}

// One block per utterance, one thread on the chain.  S is the number of
// states (2N).
extern "C" int roar_pyin_backtrack(
    const void* ptr, const void* last, void* states, int B, int T, int S, void* stream) {
  if (B < 1 || T < 1 || S < 1) return cudaErrorInvalidValue;
  // G rows (about 16 KB) a slot, R slots (at most 192 KB, at most 32)
  const size_t row_bytes = sizeof(int) * static_cast<size_t>(S);
  const int G = static_cast<int>(std::max<size_t>(1, std::min<size_t>(8, 16384 / row_bytes)));
  const size_t slot_bytes = (G * row_bytes + 15) / 16 * 16 + 16;  // + the alignment window
  const int chunks = (T - 1 + G - 1) / G;
  const int R = std::max(1, std::min({32, static_cast<int>(196608 / slot_bytes), chunks}));
  const size_t smem = 16 * ((16 * static_cast<size_t>(R) + 15) / 16) + R * slot_bytes;
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pyin_backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  pyin_backtrack_kernel<<<B, 32 * (1 + kCopyWarps), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(last),
      static_cast<int*>(states), T, S, G, R, static_cast<int>(slot_bytes / sizeof(int)));
  return cudaGetLastError();
}
