"""The bf16 wgmma forward kernel at D 128, its walk and roundings emulated on
the CPU against the bar of `chip_smoke.assert_flash_close`.

`flash_fwd_wgmma_kernel<128>` (csrc/flash_attention_fwd.cu) runs one block
per 128-query tile, two warpgroups of 64 rows, over the 128-key tiles that
`next_tile` walks: up to the block's last row with `causal`, and only those
holding a key whose segment id lies in the block's own [min, max] range.
Both warpgroups walk all of the block's tiles (they take turns issuing
their products, so their walks pair up); with `causal` the last is the
block's own diagonal tile, masked for both.  Per tile and row: s = (q . k)
* scale with fp32 sums, masked; the running maximum m taken per tile (a row
that has seen no visible key takes its exponents against 0); p = exp(s - m)
unrounded into the row sum l and rounded to bf16 for P V; o = o * alpha +
bf16(p) v in fp32; o / l rounded once to bf16 as it is stored, lse = m +
log l.

The emulation below does the same per block and warpgroup, tile by tile, and
passes the bar against the plain forward at (1, 512, 2, 128) causal, at
(2, 300, 2, 128) causal under the key mask [300, 141] and at (4, 200, 2, 128)
non-causal under [200, 1, 100, 173]; the same walk without each warpgroup's
diagonal tile (the tile of its own keys) fails it.  Inputs come from
numpy with a seed.  Card-free: no `cuda` test here.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BLOCK = 128  # query rows of a block: two warpgroups of 64
WG_ROWS = 64  # query rows of a warpgroup
TILE = 128  # keys of a streamed K/V tile
LOG2E = 1.4426950408889634
CASES = {"causal_512": ((1, 512, 2, 128), True, None),
         "causal_masked_300": ((2, 300, 2, 128), True, [300, 141]),
         "non_causal_masked_200": ((4, 200, 2, 128), False, [200, 1, 100, 173])}


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def _inputs(case: str):
    """Seeded bf16 q, k, v, the key mask, scale and `causal`."""
    (b, t, h, d), causal, lens = CASES[case]
    rng = np.random.default_rng(24)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
               .bfloat16() for _ in range(3))
    key_mask = None if lens is None else torch.arange(t)[None, :] < torch.tensor(lens)[:, None]
    return q, k, v, key_mask, 1.0 / d ** 0.5, causal


def _block_walk(seg_b: torch.Tensor, q0: int, t: int, causal: bool) -> list:
    """The 128-key tiles a block of 128 queries from `q0` walks (`next_tile`
    over `segment_range`): below the block's last row with `causal`, those
    holding an in-range key whose id lies in the block's [min, max]."""
    ids = seg_b[q0:min(q0 + BLOCK, t)]
    lo, hi = int(ids.min()), int(ids.max())
    end = min(t, q0 + BLOCK) if causal else t
    return [k0 for k0 in range(0, end, TILE)
            if bool(((seg_b[k0:min(k0 + TILE, t)] >= lo)
                     & (seg_b[k0:min(k0 + TILE, t)] <= hi)).any())]


def _forward_walk(q, k, v, key_mask, scale, causal, skip_diagonal=False):
    """o and lse as `flash_fwd_wgmma_kernel<128>` forms them: per block and
    warpgroup, tile by tile; with `skip_diagonal` each warpgroup leaves out
    the tile of its own keys."""
    b, t, h, d = q.shape
    seg = fa.segment_ids(key_mask, b, t, "cpu")
    q32, k32, v32 = q.float(), k.float(), v.float()
    out, lse = torch.zeros(b, t, h, d, dtype=q.dtype), torch.zeros(b, h, t)
    neg_inf = torch.tensor(float("-inf"))
    for bi in range(b):
        for q0 in range(0, t, BLOCK):
            walk = _block_walk(seg[bi], q0, t, causal)
            for wq0 in range(q0, min(q0 + BLOCK, t), WG_ROWS):
                rows = torch.arange(wq0, min(wq0 + WG_ROWS, t))
                tiles = [k0 for k0 in walk
                         if not (skip_diagonal and k0 == wq0 - wq0 % TILE)]
                for hi_ in range(h):
                    m = torch.full((len(rows),), float("-inf"))
                    l, o = torch.zeros(len(rows)), torch.zeros(len(rows), d)
                    for k0 in tiles:
                        keys = torch.arange(k0, min(k0 + TILE, t))
                        visible = seg[bi, rows][:, None] == seg[bi, keys][None, :]
                        if causal:
                            visible &= keys[None, :] <= rows[:, None]
                        s = (q32[bi, rows, hi_] @ k32[bi, keys, hi_].T) * scale
                        s = torch.where(visible, s, neg_inf)
                        m_new = torch.maximum(m, s.amax(1))
                        m_use = torch.where(m_new == neg_inf, torch.zeros(()), m_new)
                        alpha = torch.exp2((m - m_use) * LOG2E)
                        p = torch.exp2(s * LOG2E - (m_use * LOG2E)[:, None])
                        l = l * alpha + p.sum(1)
                        o = o * alpha[:, None] + p.bfloat16().float() @ v32[bi, keys, hi_]
                        m = m_new
                    out[bi, rows, hi_] = (o / l[:, None]).to(q.dtype)
                    lse[bi, hi_, rows] = m + torch.log(l)
    return out, lse


@pytest.mark.parametrize("skip_diagonal", [False, True], ids=["kernel_walk", "diagonal_skipped"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_wgmma_forward_walk_takes_the_bar(case, skip_diagonal):
    """The D 128 forward's walk and roundings pass the bar against the plain
    forward, o at the bf16 bar and lse at the kernels' tolerance; the same
    walk without each warpgroup's diagonal tile fails it."""
    cs = _chip_smoke()
    q, k, v, key_mask, scale, causal = _inputs(case)
    o_w, lse_w = fa.flash_self_attention_plain(q, k, v, key_mask, scale, True, causal=causal)
    o, lse = _forward_walk(q, k, v, key_mask, scale, causal, skip_diagonal=skip_diagonal)
    if skip_diagonal:
        with pytest.raises(AssertionError):
            cs.assert_flash_close(o, o_w, "o")
    else:
        errs = cs.assert_flash_close(o, o_w, "o")
        assert errs["worst_share_of_bar"] < 0.75 and errs["rel_l2"] < 5e-3
        torch.testing.assert_close(lse, lse_w, **cs.KERNEL_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_block_walks_up_to_its_own_diagonal_tile(case):
    """The walk `next_tile` gives a block, which both warpgroups take: with
    `causal` it ends at the block's own tile of 128 keys (its diagonal, the
    one tile masked for both warpgroups), and under a key mask it leaves out
    only tiles holding no key of the block's segments."""
    q, _, _, key_mask, _, causal = _inputs(case)
    b, t = q.shape[:2]
    seg = fa.segment_ids(key_mask, b, t, "cpu")
    for bi in range(b):
        for q0 in range(0, t, BLOCK):
            walk = _block_walk(seg[bi], q0, t, causal)
            ids = set(seg[bi, q0:min(q0 + BLOCK, t)].tolist())
            every = range(0, min(t, q0 + BLOCK) if causal else t, TILE)
            skipped = [k0 for k0 in every if k0 not in walk]
            assert not causal or walk[-1] == q0
            assert all(not ids & set(seg[bi, k0:min(k0 + TILE, t)].tolist())
                       for k0 in skipped)
    if case == "causal_masked_300":
        # the second row's pad block (queries 256..299, id 1) skips the
        # valid keys 0..127 and walks the mixed tile 128 and its own
        assert _block_walk(seg[1], 256, t, True) == [128, 256]
