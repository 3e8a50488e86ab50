"""K1 and K2: pYIN banded Viterbi forward pass and backtrack (CUDA kernels +
plain versions).

Port of roar_tpu/ops/pyin_pallas.py: `_viterbi_kernel` (K1, the whole forward
recursion in one launch, writing int32 back-pointers and the final scores)
and `_backtrack_kernel` (K2, `state[t-1] = ptr[t, b, state[t]]` in one
launch).  The kernels are in `csrc/pyin_viterbi.cu`; its source note says
what bounds them on the H100 and what the design does about it.

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
launches the kernel or raises.  `LAUNCHES_FWD` and `LAUNCHES_BACKTRACK`
count kernel launches.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

LAUNCHES_FWD = 0
LAUNCHES_BACKTRACK = 0
NEG = -1e30
MAX_BINS = 1024  # one thread per pitch bin


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
    log_stay: float, log_switch: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass of the banded Viterbi over log_obs [B, T, 2N] with the
    log-triangle weights log_tri [W] (W odd) and the per-bin log_norm [N].
    Returns (ptrs [B, T, 2N] int32, v_final [B, 2N] float32)."""
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
    if log_tri.dim() != 1 or w % 2 == 0 or log_norm.shape != (n,):
        raise ValueError(f"log_tri must be [W] with W odd and log_norm [{n}], got "
                         f"{tuple(log_tri.shape)}, {tuple(log_norm.shape)}")
    for name, x in (("log_obs", log_obs), ("log_tri", log_tri), ("log_norm", log_norm)):
        _check_cuda(name, x, torch.float32, log_obs.device)
    ptrs = torch.empty((b, t, n2), dtype=torch.int32, device=log_obs.device)
    v_final = torch.empty((b, n2), dtype=torch.float32, device=log_obs.device)

    from roar_tpu_torch.kernels.library import check, load_library

    lib = load_library()
    err = lib.roar_pyin_viterbi_fwd(
        log_obs.data_ptr(), log_tri.data_ptr(), log_norm.data_ptr(), ptrs.data_ptr(),
        v_final.data_ptr(), b, t, n, w, float(log_stay), float(log_switch),
        math.log(1.0 / n), torch.cuda.current_stream(log_obs.device).cuda_stream,
    )
    check(lib, err, "pyin_viterbi_fwd launch")
    global LAUNCHES_FWD
    LAUNCHES_FWD += 1
    return ptrs, v_final


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
