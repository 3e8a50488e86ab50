"""K1 and K2: pYIN banded Viterbi forward pass and backtrack (CUDA kernels +
plain versions).

Port of roar_tpu/ops/pyin_pallas.py: `_viterbi_kernel` (K1, the whole forward
recursion in one launch, writing int32 back-pointers and the final scores)
and `_backtrack_kernel` (K2, `state[t-1] = ptr[t, b, state[t]]` in one
launch).  The kernels are in `csrc/pyin_viterbi.cu`, designed for Hopper.

What bounds them on an H100 is the chain of T dependent frames, not bytes or
peak arithmetic.  K1 therefore spreads one utterance over a thread-block
cluster of C blocks, each owning ceil(N/C) bins, so that a frame's band work
is shared by C SMs; a frame then costs its band work on one SM (the
compares and selects, on the half-rate ALU pipe) plus the halo exchange.  C
is `cluster_size`: the largest of 8, 4, 2, 1 with B*C <= the SM count and
ceil(N/C) >= W//2, so the W//2 halo a block needs on each side comes from
its immediate neighbours.  Each block pushes its W//2 edge values and
source-half selector bits into its neighbours' halos through distributed
shared memory (`st.async`, completing on the receiver's mbarrier), so a
frame needs only a block barrier and that mbarrier's wait, no cluster-scope
fence; the rows are double-buffered by frame parity, and a block overwrites
a neighbour's buffer only after that neighbour's next push has shown it done
reading.  Within a block a bin's band max is split over lanes of one warp,
each a running strict `>` over a sub-range of offsets, combined by warp
shuffles under the plain version's rule.

K2 streams the pointer rows t-1, t-2, ... into a ring of shared-memory slots
(16-byte `cp.async` by three copying warps) ahead of the one thread that
follows the chain.  A row is 2N*4 bytes, so rows start off a 16-byte
boundary: each copy takes the aligned window around its rows and the chain
indexes with the offset.

Layouts are the caller's, without the TPU's lane and sublane padding:
log_obs [B, T, 2N] float32 with the states as [voiced | unvoiced] halves,
pointers [B, T, 2N] int32 (row 0 unused, written as 0), final scores
[B, 2N], states [B, T] int32.

The arithmetic is fp32 additions and comparisons in the order of
roar_tpu/ops/pyin.py `banded_viterbi_decode`, so kernel, plain version and
the JAX scan decode bit-identically: `(v - log_norm) + log_stay`, then
`+ log_tri[o]`, then `+ log_obs`; offsets ascending with a strict `>`, so the
first maximum wins; the half selector a strict `>`; the source bin clipped
to [0, N-1] before its half is looked up; -1e30, never -inf.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises (a launch the card refuses raises too: there
is no other route).  `LAUNCHES_FWD` and `LAUNCHES_BACKTRACK` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

LAUNCHES_FWD = 0
LAUNCHES_BACKTRACK = 0
NEG = -1e30
MAX_BINS = 1024  # N
MAX_WIDTH = 2047  # W: the band weights live in the kernel's constant memory
CLUSTER_SIZES = (8, 4, 2, 1)  # 8: the portable cluster limit


def cluster_admissible(n: int, w: int, c: int) -> bool:
    """Whether K1 can spread an utterance of N bins with band W over C
    blocks: C is 1, 2, 4 or 8, and for C > 1 every block owns at least W//2
    bins (ceil(N/C) >= W//2), so its halos come from its neighbours only."""
    return c in CLUSTER_SIZES and (c == 1 or -(-n // c) >= w // 2)


def cluster_size(b: int, n: int, w: int, sm_count: int) -> int:
    """K1's blocks per utterance: the largest admissible C of 8, 4, 2, 1
    with B*C <= `sm_count`, else 1."""
    for c in CLUSTER_SIZES:
        if b * c <= sm_count and cluster_admissible(n, w, c):
            return c
    return 1


def viterbi_forward_plain(
    log_obs: torch.Tensor, log_tri: torch.Tensor, log_norm: torch.Tensor,
    log_stay: float, log_switch: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain PyTorch version: a Python loop over frames of tensor ops.
    Returns (ptrs [B, T, 2N] int32, v_final [B, 2N] float32)."""
    b, t, n2 = log_obs.shape
    n, w = n2 // 2, log_tri.shape[0]
    half = w // 2
    bins = torch.arange(n, device=log_obs.device)

    def band_max(wvals):
        # windows[b, j, o] = wvals[b, j + o - half] + log_tri[o]; `max` returns
        # the first maximum, and a maximum that does not exceed -1e30 is not
        # taken (offset 0), as in a running strict `>` from -1e30
        windows = F.pad(wvals, (half, half), value=NEG).unfold(1, w, 1) + log_tri
        best, off = torch.max(windows, dim=-1)
        take = best > NEG
        best = torch.where(take, best, NEG)
        off = torch.where(take, off, 0)
        return best, torch.clamp(bins - half + off, 0, n - 1)

    init = log_obs.new_full((n2,), NEG)
    init[n:] = math.log(1.0 / n)
    v = init + log_obs[:, 0]
    ptrs = torch.zeros((b, t, n2), dtype=torch.int32, device=log_obs.device)
    for i in range(1, t):
        u_v = v[:, :n] - log_norm
        u_u = v[:, n:] - log_norm
        stay_v, switch_u = u_v + log_stay, u_u + log_switch
        switch_v, stay_u = u_v + log_switch, u_u + log_stay
        best_v, src_v = band_max(torch.maximum(stay_v, switch_u))  # -> voiced
        best_u, src_u = band_max(torch.maximum(switch_v, stay_u))  # -> unvoiced
        # which half each source came from
        ptr_v = src_v + torch.gather(switch_u > stay_v, 1, src_v) * n
        ptr_u = src_u + torch.gather(stay_u > switch_v, 1, src_u) * n
        ptrs[:, i] = torch.cat([ptr_v, ptr_u], dim=1)
        v = torch.cat([best_v, best_u], dim=1) + log_obs[:, i]
    return ptrs, v


def viterbi_backtrack_plain(ptrs: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """K2's plain PyTorch version: a loop of gathers.  ptrs [B, T, S] int32,
    last [B] int32 -> states [B, T] int32."""
    t = ptrs.shape[1]
    state = last.long()
    states = [state]
    for i in range(t - 1, 0, -1):
        state = torch.gather(ptrs[:, i], 1, state[:, None])[:, 0].long()
        states.append(state)
    return torch.stack(states[::-1], dim=1).to(torch.int32)


def _check_cuda(name: str, x: torch.Tensor, dtype: torch.dtype, device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def viterbi_forward(
    log_obs: torch.Tensor, log_tri: torch.Tensor, log_norm: torch.Tensor,
    log_stay: float, log_switch: float, cluster: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass of the banded Viterbi over log_obs [B, T, 2N] with the
    log-triangle weights log_tri [W] (W odd) and the per-bin log_norm [N].
    Returns (ptrs [B, T, 2N] int32, v_final [B, 2N] float32).

    `cluster` forces K1's blocks per utterance (for tests and measurements;
    raises if the shape does not admit it); by default `cluster_size`."""
    if cluster is not None and not cluster_admissible(
            log_obs.shape[-1] // 2, log_tri.shape[0], cluster):
        raise ValueError(f"viterbi_forward: cluster={cluster} is not admissible at N="
                         f"{log_obs.shape[-1] // 2}, W={log_tri.shape[0]} (C in 1, 2, 4, 8 "
                         "and ceil(N/C) >= W//2)")
    if log_obs.device.type == "cpu":
        return viterbi_forward_plain(log_obs, log_tri, log_norm, log_stay, log_switch)
    if log_obs.device.type != "cuda":
        raise ValueError(f"viterbi_forward: no kernel for device {log_obs.device}")
    if log_obs.dim() != 3 or log_obs.shape[-1] % 2:
        raise ValueError(f"log_obs must be [B, T, 2N], got {tuple(log_obs.shape)}")
    b, t, n2 = log_obs.shape
    n, w = n2 // 2, log_tri.shape[0]
    if b < 1 or t < 1 or not 1 <= n <= MAX_BINS:
        raise ValueError(f"viterbi_forward takes B, T >= 1 and 1 <= N <= {MAX_BINS}, got "
                         f"B={b}, T={t}, N={n}")
    if log_tri.dim() != 1 or w % 2 == 0 or w > MAX_WIDTH or log_norm.shape != (n,):
        raise ValueError(f"log_tri must be [W] with W odd and at most {MAX_WIDTH}, and "
                         f"log_norm [{n}], got {tuple(log_tri.shape)}, {tuple(log_norm.shape)}")
    for name, x in (("log_obs", log_obs), ("log_tri", log_tri), ("log_norm", log_norm)):
        _check_cuda(name, x, torch.float32, log_obs.device)
    if cluster is None:
        sm_count = torch.cuda.get_device_properties(log_obs.device).multi_processor_count
        cluster = cluster_size(b, n, w, sm_count)
    ptrs = torch.empty((b, t, n2), dtype=torch.int32, device=log_obs.device)
    v_final = torch.empty((b, n2), dtype=torch.float32, device=log_obs.device)

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    err = lib.roar_pyin_viterbi_fwd(
        log_obs.data_ptr(), log_tri.data_ptr(), log_norm.data_ptr(), ptrs.data_ptr(),
        v_final.data_ptr(), b, t, n, w, cluster, float(log_stay), float(log_switch),
        math.log(1.0 / n), torch.cuda.current_stream(log_obs.device).cuda_stream,
    )
    check(lib, err, "pyin_viterbi_fwd launch")
    global LAUNCHES_FWD
    LAUNCHES_FWD += 1
    return ptrs, v_final


def max_active_clusters(b: int, n: int, w: int, cluster: int) -> int:
    """`cudaOccupancyMaxActiveClusters` of K1's launch at (B, N, W, C) on the
    current device: how many of its clusters the card can hold at once."""
    if not cluster_admissible(n, w, cluster):
        raise ValueError(f"cluster={cluster} is not admissible at N={n}, W={w}")
    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    out = ctypes.c_int(0)
    check(lib, lib.roar_pyin_viterbi_max_active_clusters(b, n, w, cluster, ctypes.byref(out)),
          "cudaOccupancyMaxActiveClusters")
    return out.value


def viterbi_backtrack(ptrs: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Walk the back-pointers from the final states.  ptrs [B, T, S] int32,
    last [B] int32 in [0, S) -> states [B, T] int32."""
    if ptrs.device.type == "cpu":
        return viterbi_backtrack_plain(ptrs, last)
    if ptrs.device.type != "cuda":
        raise ValueError(f"viterbi_backtrack: no kernel for device {ptrs.device}")
    if ptrs.dim() != 3 or last.shape != ptrs.shape[:1]:
        raise ValueError(f"ptrs must be [B, T, S] and last [B], got "
                         f"{tuple(ptrs.shape)}, {tuple(last.shape)}")
    _check_cuda("ptrs", ptrs, torch.int32, ptrs.device)
    _check_cuda("last", last, torch.int32, ptrs.device)
    b, t, s = ptrs.shape
    states = torch.empty((b, t), dtype=torch.int32, device=ptrs.device)

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    err = lib.roar_pyin_backtrack(
        ptrs.data_ptr(), last.data_ptr(), states.data_ptr(), b, t, s,
        torch.cuda.current_stream(ptrs.device).cuda_stream,
    )
    check(lib, err, "pyin_backtrack launch")
    global LAUNCHES_BACKTRACK
    LAUNCHES_BACKTRACK += 1
    return states
