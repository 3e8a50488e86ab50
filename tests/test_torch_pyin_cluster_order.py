"""K1's work split, emulated on the CPU: the cluster of blocks, the halos
pushed between neighbours, the offset sub-ranges and their shuffle combine.

`roar_tpu_torch/csrc/pyin_viterbi.cu` spreads one utterance's frame over C
blocks (each owning ceil(N/C) bins and a W//2 halo on each side, filled by
its neighbours' pushes of values and selector bits into double-buffered
rows), splits each bin's band max over P lanes (each a running strict `>`
from -1e30 over a sub-range of ceil(W/P) offsets) and combines the P
partials by an xor butterfly: the larger value wins, on equal values the
lower offset, and a best that never exceeds -1e30 keeps offset 0.  The model
below does the same steps in the same order with torch ops, so the kernel's
decomposition is held here, with no card, to the plain version bit for bit
(`torch.equal`), and at one small shape to the JAX package's Pallas kernel in
interpret mode.  The kernel's rule for P is read from the CUDA source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import pyin_viterbi as pv
from roar_tpu_torch.ops.pyin import _band_tables

NEG = -1e30
SOURCE = Path(__file__).resolve().parents[1] / "roar_tpu_torch" / "csrc" / "pyin_viterbi.cu"
LOG_STAY, LOG_SWITCH = float(np.log1p(-0.01)), float(np.log(0.01))


def _chip_smoke():
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def kernel_lanes(s: int) -> int:
    """P of the kernel at S bins a block (`pick_lanes`): the largest of 8,
    4, 2 with S P <= kThreadTarget, else 1, with kThreadTarget read from the
    source."""
    target = int(re.search(r"constexpr int kThreadTarget = (\d+);",
                           SOURCE.read_text()).group(1))
    return next((p for p in (8, 4, 2) if s * p <= target), 1)


def emulate_forward(log_obs, log_tri, log_norm, cluster, lanes=None, push=True):
    """K1 as the kernel computes it.  log_obs [B, T, 2N] float32; returns
    (ptrs [B, T, 2N] int32, v_final [B, 2N]).  `lanes` overrides the
    kernel's P; `push=False` leaves the halos unfilled."""
    b, t, n2 = log_obs.shape
    n, w = n2 // 2, log_tri.shape[0]
    half = w // 2
    s = -(-n // cluster)
    p_ = lanes or kernel_lanes(s)
    sub_len = -(-w // p_)
    row_len = s + p_ * sub_len - 1
    tri = torch.cat([log_tri, log_tri.new_full((p_ * sub_len - w,), NEG)])  # past W: never wins
    subs = torch.arange(p_)

    # the (block, bin) pairs that own a bin, and those that push an edge
    blocks = torch.arange(cluster)[:, None].expand(cluster, s)
    local = torch.arange(s)[None, :].expand(cluster, s)
    lo = torch.clamp(torch.arange(cluster) * s, max=n)
    owned = lo[:, None] + local < n
    c_own, g_own = blocks[owned], local[owned]
    j_own = lo[c_own] + g_own
    left = owned & (blocks > 0) & (local < half)
    right = owned & (blocks < cluster - 1) & (local >= s - half)
    # lane (bin g, sub-range p) reads row[g + p L + q] for q < L
    idx = torch.arange(s)[:, None, None] + subs[None, :, None] * sub_len + torch.arange(sub_len)
    weights = tri[subs[:, None] * sub_len + torch.arange(sub_len)]  # [P, L]

    # per block and frame parity: (w_same, w_cross) rows and selector bits,
    # -1e30 and 0 until written, kept from frame to frame
    rows = log_obs.new_full((cluster, 2, b, row_len, 2), NEG)
    sels = torch.zeros((cluster, 2, b, row_len), dtype=torch.uint8)
    ptrs = torch.zeros((b, t, n2), dtype=torch.int32)
    init = log_obs.new_full((n2,), NEG)
    init[n:] = float(np.log(1.0 / n))
    v = init + log_obs[:, 0]
    for i in range(1, t):
        buf = i & 1
        u_v = v[:, :n] - log_norm
        u_u = v[:, n:] - log_norm
        stay_v, switch_u = u_v + LOG_STAY, u_u + LOG_SWITCH
        switch_v, stay_u = u_v + LOG_SWITCH, u_u + LOG_STAY
        entry = torch.stack([torch.maximum(stay_v, switch_u), torch.maximum(switch_v, stay_u)], -1)
        sel = (switch_u > stay_v).to(torch.uint8) | ((stay_u > switch_v).to(torch.uint8) << 1)
        # each owner writes its own entry and pushes its edges to the neighbours
        targets = [(owned, 0)] + ([(left, -1), (right, 1)] if push else [])
        for mask, step in targets:
            c, g = blocks[mask], local[mask]
            j = lo[c] + g
            x = g + half - step * s
            rows[c + step, buf, :, x] = entry[:, j].transpose(0, 1)
            sels[c + step, buf, :, x] = sel[:, j].transpose(0, 1)
        # (the halo arrivals and the block barrier); every block's band at
        # once, cand [C, B, S, P, L, 2], each sub-range a running strict >
        cand = rows[:, buf][:, :, idx] + weights[None, None, None, :, :, None]
        best = log_obs.new_full((cluster, b, s, p_, 2), NEG)
        off = torch.zeros((cluster, b, s, p_, 2), dtype=torch.int64)
        for q in range(sub_len):
            take = cand[:, :, :, :, q] > best
            best = torch.where(take, cand[:, :, :, :, q], best)
            off = torch.where(take, q, off)
        off = torch.where(best > NEG, off + (subs * sub_len)[:, None], 0)
        m = 1
        while m < p_:  # the xor butterfly of the shuffles
            other, other_off = best[:, :, :, subs ^ m], off[:, :, :, subs ^ m]
            take = (other > best) | ((other == best) & (other_off < off))
            best, off = torch.where(take, other, best), torch.where(take, other_off, off)
            m *= 2
        best, off = best[c_own, :, g_own, 0], off[c_own, :, g_own, 0]  # [owned, B, 2]
        # pointers, with the source half read at the clamped source bin
        srcs = torch.clamp(j_own[:, None, None] - half + off, 0, n - 1)
        flags = sels[c_own, buf][torch.arange(len(c_own))[:, None, None],
                                 torch.arange(b)[None, :, None],
                                 srcs - (lo[c_own] - half)[:, None, None]]
        bits = torch.tensor([1, 2], dtype=torch.uint8)
        ptr = (srcs + ((flags & bits) > 0).long() * n).int()
        v_new = best + log_obs[:, i].view(b, 2, n)[:, :, j_own].permute(2, 0, 1)
        for h in range(2):
            ptrs[:, i, h * n + j_own] = ptr[:, :, h].transpose(0, 1)
            v[:, h * n + j_own] = v_new[:, :, h].transpose(0, 1)
    return ptrs, v


def _inputs(b, t, n, w, ties, seed=0):
    """`chip_smoke.viterbi_log_obs` rows, and with `ties` one more row: a
    comb of equal peaks 20 bins apart in every frame, so a bin midway
    between two peaks sees an exact tie at offsets W//2 -+ 10, which lie in
    different sub-ranges for every P > 1 at W 71 and 101."""
    log_obs = _chip_smoke().viterbi_log_obs(np.random.default_rng(seed), b, t, n, ties)
    if ties:
        comb = np.full((1, t, 2 * n), -700.0, np.float32)
        comb[:, :, ::20] = np.float32(np.log(0.05))
        log_obs = np.concatenate([log_obs, comb])
    log_tri, log_norm = (torch.from_numpy(a) for a in _band_tables(n, w))
    return torch.from_numpy(log_obs), log_tri, log_norm


SHAPES = [(3, 14, 279, 71), (2, 9, 601, 101), (1, 2, 601, 101)]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=["n279", "n601", "t2"])
def test_cluster_split_equals_plain(shape, cluster):
    """The kernel's split at C blocks, with the tie-heavy inputs of
    `chip_smoke.viterbi_log_obs(ties=True)` (a constant row; a repeated frame
    where B > 1) and a comb row, bit for bit."""
    b, t, n, w = shape
    log_obs, log_tri, log_norm = _inputs(b, t, n, w, ties=True)
    assert pv.cluster_admissible(n, w, cluster)
    got_ptrs, got_final = emulate_forward(log_obs, log_tri, log_norm, cluster)
    want_ptrs, want_final = pv.viterbi_forward_plain(log_obs, log_tri, log_norm, LOG_STAY,
                                                     LOG_SWITCH)
    assert torch.equal(got_ptrs, want_ptrs)
    assert torch.equal(got_final, want_final)


@pytest.mark.parametrize("lanes,cluster", [(1, 4), (2, 4), (4, 4), (8, 4), (8, 1), (2, 8),
                                           (8, 8)])
def test_every_lane_split_equals_plain(lanes, cluster):
    """Any P lanes a bin gives the plain version's bits, at (3, 14, 279, 71),
    random and tie-heavy rows."""
    log_obs, log_tri, log_norm = _inputs(3, 14, 279, 71, ties=True, seed=1)
    got_ptrs, got_final = emulate_forward(log_obs, log_tri, log_norm, cluster, lanes)
    want_ptrs, want_final = pv.viterbi_forward_plain(log_obs, log_tri, log_norm, LOG_STAY,
                                                     LOG_SWITCH)
    assert torch.equal(got_ptrs, want_ptrs) and torch.equal(got_final, want_final)


def test_missing_halo_is_caught():
    """The model is not blind to the halos: without the pushes into the
    neighbours' halos its pointers differ from the plain version's."""
    log_obs, log_tri, log_norm = _inputs(2, 9, 601, 101, ties=False, seed=2)
    want_ptrs, _ = pv.viterbi_forward_plain(log_obs, log_tri, log_norm, LOG_STAY, LOG_SWITCH)
    got_ptrs, _ = emulate_forward(log_obs, log_tri, log_norm, 8, push=False)
    assert not torch.equal(got_ptrs, want_ptrs)


def test_cluster_split_equals_pallas_interpret():
    """At (3, 14, 279, 71) over 8 blocks the split's pointers and final
    scores equal the JAX package's Pallas kernel K1 in interpret mode, run
    as tests/test_torch_pyin.py runs it (TPU layout, lanes padded to 128)."""
    import jax.numpy as jnp

    from roar_tpu.ops.pyin_pallas import _viterbi_pallas_call

    t, n, w = 14, 279, 71
    log_obs, log_tri, log_norm = _inputs(2, t, n, w, ties=True, seed=3)
    b = log_obs.shape[0]  # two rows and the comb
    bp, np_ = 8, 384
    obs = np.full((t, bp, 2, np_), -1e30, np.float32)
    obs[:, :b, :, :n] = log_obs.numpy().transpose(1, 0, 2).reshape(t, b, 2, n)
    obs[:, b:, :, :n] = 0.0
    norm = np.zeros((1, np_), np.float32)
    norm[0, :n] = log_norm.numpy()
    ptrs, v_final = _viterbi_pallas_call(
        jnp.asarray(obs), jnp.asarray(norm), log_tri=tuple(float(x) for x in log_tri), n=n,
        width=w, log_stay=LOG_STAY, log_switch=LOG_SWITCH, log_init_u=float(np.log(1.0 / n)),
        interpret=True)
    got_ptrs, got_final = emulate_forward(log_obs, log_tri, log_norm, 8)
    want_ptrs = np.asarray(ptrs)[1:, :b, :, :n].reshape(t - 1, b, 2 * n).transpose(1, 0, 2)
    np.testing.assert_array_equal(got_ptrs.numpy()[:, 1:], want_ptrs)
    want_final = np.asarray(v_final)[:b, :, :n].reshape(b, 2 * n)
    np.testing.assert_array_equal(got_final.numpy(), want_final)


def test_cluster_rule():
    """8 blocks at the CLI's bucket (16 utterances, N 601, W 101, 132 SMs), 1
    at 128 utterances; never a C whose blocks own fewer than W//2 bins, never
    more blocks than SMs unless C is 1, and never a smaller C than the rule
    allows."""
    assert pv.cluster_size(16, 601, 101, 132) == 8
    assert pv.cluster_size(128, 601, 101, 132) == 1
    assert pv.cluster_size(3, 279, 71, 132) == 8  # ceil(279/8) = 35 = W//2
    assert pv.cluster_size(3, 279, 73, 132) == 4
    for n in list(range(1, 80)) + [279, 300, 601, 1000, 1024]:
        for w in (1, 3, 5, 71, 101, 201, 999):
            for b in (1, 16, 17, 33, 34, 66, 67, 128, 200):
                for sms in (132, 114):
                    c = pv.cluster_size(b, n, w, sms)
                    assert c in (1, 2, 4, 8)
                    assert c == 1 or (-(-n // c) >= w // 2 and b * c <= sms)
                    larger = [d for d in (2, 4, 8) if d > c and b * d <= sms
                              and -(-n // d) >= w // 2]
                    assert not larger, (b, n, w, sms, c)


def test_forced_cluster_is_checked():
    log_obs, log_tri, log_norm = _inputs(1, 3, 279, 101, ties=False)
    for bad in (3, 16, 0, 8):  # 8: ceil(279/8) = 35 < 50
        with pytest.raises(ValueError):
            pv.viterbi_forward(log_obs, log_tri, log_norm, LOG_STAY, LOG_SWITCH, cluster=bad)
    ptrs, v_final = pv.viterbi_forward(log_obs, log_tri, log_norm, LOG_STAY, LOG_SWITCH,
                                       cluster=4)
    want = pv.viterbi_forward_plain(log_obs, log_tri, log_norm, LOG_STAY, LOG_SWITCH)
    assert torch.equal(ptrs, want[0]) and torch.equal(v_final, want[1])
