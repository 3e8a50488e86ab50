"""The bf16 wgmma backward kernels at D 128 and 256, their walks and roundings
emulated on the CPU against the bar of `chip_smoke.assert_flash_close`.

`flash_bwd_dkv_wgmma_kernel` (csrc/flash_attention_bwd.cu) runs one block per
key tile of `BLOCK_ROWS[d]` rows (64 at D 256, 128 at D 128) over the visible
64-query tiles from the block's diagonal on.  At D 256 one warpgroup forms
S^T = K Q^T and P^T = exp(S^T * scale - lse), masked, and adds bf16(P^T) dO
into dV; the other forms dP^T = V dO^T, takes the unrounded P^T across, forms
dS^T = P^T (dP^T - delta) * scale and adds bf16(dS^T) Q into dK.  At D 128
each warpgroup owns 64 keys of the block whole and does all of that for them,
and skips the products of a query tile that lies wholly before its keys.
`flash_bwd_dq_wgmma_kernel` runs one block per query tile of the same rows
over the visible 64-key tiles up to the block's diagonal: S and dP are each
formed once per 64 queries, dS from the unrounded P, rounded to bf16, and
added times K into dQ (at D 256 each warpgroup adds that same dS times its
own 128 columns of K; at D 128 each warpgroup owns 64 queries whole and skips
a key tile that lies wholly after them).  Every sum is fp32, one tile at a
time in the walk's order, and each output is rounded once as it is stored.
Both walks skip, as `next_tile` does, a tile whose segment ids all lie
outside the block's own [min, max] range.

The emulations below do the same per block and warpgroup, tile by tile, and
pass the bar against the plain backward at (1, 512, 2, d) causal and at
(2, 300, 2, d) causal under the key mask [300, 141], d 256 and 128; the same
walks without each warpgroup's diagonal tile fail it.  Inputs come from numpy
with a seed.  Card-free: no `cuda` test here.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TILE = 64  # rows of a streamed tile and of a warpgroup's share of a block
BLOCK_ROWS = {256: 64, 128: 128}  # rows a block owns, by head size
LOG2E = 1.4426950408889634
CASES = {"d256_causal_512": ((1, 512, 2, 256), None),
         "d256_masked_300": ((2, 300, 2, 256), [300, 141]),
         "d128_causal_512": ((1, 512, 2, 128), None),
         "d128_masked_300": ((2, 300, 2, 128), [300, 141])}


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def _inputs(case: str):
    """Seeded bf16 q, k, v, dO, the key mask, scale, and the plain forward's
    o and lse (causal)."""
    (b, t, h, d), lens = CASES[case]
    rng = np.random.default_rng(19)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
                   .bfloat16() for _ in range(4))
    key_mask = None if lens is None else torch.arange(t)[None, :] < torch.tensor(lens)[:, None]
    scale = 1.0 / d ** 0.5
    o, lse = fa.flash_self_attention_plain(q, k, v, key_mask, scale, True, causal=True)
    return q, k, v, do, key_mask, scale, o, lse


def _visible_tiles(seg_b: torch.Tensor, start: int, end: int, t: int, lo: int, hi: int) -> list:
    """`next_tile`'s walk: the 64-row tiles from `start` below `end` that hold
    an in-range row whose segment id lies in [lo, hi]."""
    out = []
    for t0 in range(start, end, TILE):
        ids = seg_b[t0:min(t0 + TILE, t)]
        if bool(((ids >= lo) & (ids <= hi)).any()):
            out.append(t0)
    return out


def _block_range(seg_b: torch.Tensor, r0: int, t: int, rows: int = TILE) -> tuple:
    """`segment_range`: the [min, max] id of the in-range rows of a block."""
    ids = seg_b[r0:min(r0 + rows, t)]
    return int(ids.min()), int(ids.max())


def _probabilities(scores, lse_rows, scale, visible):
    """p = exp2(s * scale * log2 e - lse * log2 e), 0 where not visible."""
    p = torch.exp2(scores * (scale * LOG2E) - lse_rows * LOG2E)
    return torch.where(visible, p, torch.zeros_like(p))


def _walk_setup(q, k, v, do, key_mask, o):
    b, t = q.shape[:2]
    seg = fa.segment_ids(key_mask, b, t, "cpu")
    delta = (o.float() * do.float()).sum(-1).permute(0, 2, 1)  # [B, H, T]
    return seg, delta, (q.float(), k.float(), v.float(), do.float())


def _dkv_walk(q, k, v, do, key_mask, scale, o, lse, skip_diagonal=False):
    """dK and dV as `flash_bwd_dkv_wgmma_kernel` forms them (causal): per
    block, each warpgroup's 64 keys over the block's walk; with
    `skip_diagonal` each warpgroup leaves out its own diagonal query tile."""
    b, t, h, d = q.shape
    block = BLOCK_ROWS[d]
    seg, delta, (q32, k32, v32, do32) = _walk_setup(q, k, v, do, key_mask, o)
    dk, dv = torch.zeros(b, t, h, d), torch.zeros(b, t, h, d)
    for bi in range(b):
        for k0 in range(0, t, block):
            lo, hi = _block_range(seg[bi], k0, t, block)
            walk = _visible_tiles(seg[bi], k0, t, t, lo, hi)
            for wk0 in range(k0, min(k0 + block, t), TILE):
                keys = torch.arange(wk0, min(wk0 + TILE, t))
                for hi_ in range(h):
                    acc_dk, acc_dv = torch.zeros(len(keys), d), torch.zeros(len(keys), d)
                    for q0 in walk:
                        if q0 + TILE <= wk0 or (skip_diagonal and q0 == wk0):
                            continue  # the tile's queries all precede these keys
                        queries = torch.arange(q0, min(q0 + TILE, t))
                        visible = ((seg[bi, keys][:, None] == seg[bi, queries][None, :])
                                   & (keys[:, None] <= queries[None, :]))
                        qt, ot = q32[bi, queries, hi_], do32[bi, queries, hi_]
                        # S^T and P^T (fp32, unrounded until the product)
                        pt = _probabilities(k32[bi, keys, hi_] @ qt.T,
                                            lse[bi, hi_, queries][None, :], scale, visible)
                        # dP^T, and dS^T from the unrounded P^T
                        dpt = v32[bi, keys, hi_] @ ot.T
                        dst = pt * (dpt - delta[bi, hi_, queries][None, :]) * scale
                        acc_dv += pt.bfloat16().float() @ ot
                        acc_dk += dst.bfloat16().float() @ qt
                    dk[bi, keys, hi_], dv[bi, keys, hi_] = acc_dk, acc_dv
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq_walk(q, k, v, do, key_mask, scale, o, lse, skip_diagonal=False):
    """dQ as `flash_bwd_dq_wgmma_kernel` forms it (causal): per block, each
    64 queries over the block's walk, each column part (two halves at D 256,
    one whole at D 128) from the same dS; with `skip_diagonal` each 64 queries
    leave out their own diagonal key tile."""
    b, t, h, d = q.shape
    block = BLOCK_ROWS[d]
    parts = [slice(0, d // 2), slice(d // 2, d)] if d == 256 else [slice(0, d)]
    seg, delta, (q32, k32, v32, do32) = _walk_setup(q, k, v, do, key_mask, o)
    dq = torch.zeros(b, t, h, d)
    for bi in range(b):
        for q0 in range(0, t, block):
            lo, hi = _block_range(seg[bi], q0, t, block)
            walk = _visible_tiles(seg[bi], 0, min(t, q0 + block), t, lo, hi)
            for wq0 in range(q0, min(q0 + block, t), TILE):
                queries = torch.arange(wq0, min(wq0 + TILE, t))
                for hi_ in range(h):
                    acc = torch.zeros(len(queries), d)
                    for k0 in walk:
                        if k0 >= wq0 + TILE or (skip_diagonal and k0 == wq0):
                            continue  # the tile's keys all follow these queries
                        keys = torch.arange(k0, min(k0 + TILE, t))
                        visible = ((seg[bi, queries][:, None] == seg[bi, keys][None, :])
                                   & (keys[None, :] <= queries[:, None]))
                        kt = k32[bi, keys, hi_]
                        # S and P; dP, dS (from the unrounded P), rounded to bf16
                        p = _probabilities(q32[bi, queries, hi_] @ kt.T,
                                           lse[bi, hi_, queries][:, None], scale, visible)
                        dp = do32[bi, queries, hi_] @ v32[bi, keys, hi_].T
                        ds = (p * (dp - delta[bi, hi_, queries][:, None]) * scale).bfloat16().float()
                        for part in parts:
                            acc[:, part] += ds @ kt[:, part]
                    dq[bi, queries, hi_] = acc
    return dq.to(q.dtype)


@pytest.mark.parametrize("skip_diagonal", [False, True], ids=["kernel_walk", "diagonal_skipped"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_wgmma_dkv_walk_takes_the_bar(case, skip_diagonal):
    """The dK/dV kernel's walk and roundings pass the bar against the plain
    backward; the same walk without each warpgroup's diagonal tile fails it."""
    close = _chip_smoke().assert_flash_close
    q, k, v, do, key_mask, scale, o, lse = _inputs(case)
    _, dk_w, dv_w = fa.flash_self_attention_bwd_plain(q, k, v, key_mask, scale, o, lse, do, True)
    dk, dv = _dkv_walk(q, k, v, do, key_mask, scale, o, lse, skip_diagonal=skip_diagonal)
    for name, got, want in (("dk", dk, dk_w), ("dv", dv, dv_w)):
        if skip_diagonal:
            with pytest.raises(AssertionError):
                close(got, want, name)
        else:
            errs = close(got, want, name)
            assert errs["worst_share_of_bar"] < 0.75 and errs["rel_l2"] < 5e-3


@pytest.mark.parametrize("skip_diagonal", [False, True], ids=["kernel_walk", "diagonal_skipped"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_wgmma_dq_walk_takes_the_bar(case, skip_diagonal):
    """The dQ kernel's walk and roundings pass the bar against the plain
    backward; the same walk without each 64 queries' diagonal tile fails it."""
    close = _chip_smoke().assert_flash_close
    q, k, v, do, key_mask, scale, o, lse = _inputs(case)
    dq_w = fa.flash_self_attention_bwd_plain(q, k, v, key_mask, scale, o, lse, do, True)[0]
    dq = _dq_walk(q, k, v, do, key_mask, scale, o, lse, skip_diagonal=skip_diagonal)
    if skip_diagonal:
        with pytest.raises(AssertionError):
            close(dq, dq_w, "dq")
    else:
        errs = close(dq, dq_w, "dq")
        assert errs["worst_share_of_bar"] < 0.75 and errs["rel_l2"] < 5e-3


@pytest.mark.parametrize("block", [64, 128], ids=["d256_block_64", "d128_block_128"])
def test_walk_skips_the_tiles_outside_a_block_segment_range(block):
    """Under the key mask [300, 141] the second row's blocks walk, from their
    diagonal, only the 64-row tiles that hold one of their ids: at 64 rows
    the valid keys 0..63 walk the query tiles 0, 64 and 128 (the last holds
    valid queries 128..140) and skip the all-pad tiles 192 and 256, the pad
    key block 192 walks 192 and 256 only, and the mixed block 128 every tile
    from its diagonal on; at 128 rows the valid block 0 walks 0, 64 and 128,
    the mixed block 128 (keys 128..140 valid) 128, 192 and 256, and the pad
    block 256 its own tile."""
    seg = fa.segment_ids(_inputs("d256_masked_300")[4], 2, 300, "cpu")[1]

    def walk(r0):
        return _visible_tiles(seg, r0, 300, 300, *_block_range(seg, r0, 300, block))

    if block == 64:
        assert walk(0) == [0, 64, 128] and walk(192) == [192, 256]
        assert _block_range(seg, 128, 300, block) == (0, 1) and walk(128) == [128, 192, 256]
    else:
        assert walk(0) == [0, 64, 128] and walk(256) == [256]
        assert _block_range(seg, 128, 300, block) == (0, 1) and walk(128) == [128, 192, 256]
