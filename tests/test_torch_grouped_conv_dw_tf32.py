"""The arithmetic of the K4 kernel (grouped-conv weight gradient on the tensor
cores, 3xTF32), emulated in numpy on the CPU.

`csrc/grouped_conv.cu` (`dw_mma_kernel`) contracts over batch x width
positions.  A block walks its part of them in items of 64 positions of one
batch row, and each item in k-chunks of 8 (a row's tail item holds fewer
valid positions; the rest of its last chunk is zeros).  Every fp32 operand v
is rounded to TF32 as big = tf32(v) and small = tf32(v - big) (round to
nearest, ties away from zero, 10 mantissa bits: the bits of `cvt.rna`).  Per
k-chunk, small.big, then big.small, then big.big go into a fresh accumulator
(`mma.sync.m16n8k8`), which one fp32 add rounded to nearest puts into the
thread's sum.  A second pass adds the parts' sums in part order.

The emulation forms each chunk's products exactly and rounds once per
`mma`, to nearest or toward zero (the H100's tensor cores truncate), on one
production-like contraction: one group of the multi-scale discriminator's
first grouped layer (cin 128, cout 128, stride 2, 4 groups: 32 input channels
x 41 taps against 32 output channels) over two batch rows of 2049 positions
(the layer's width at scale 1), cut into parts of the length the kernel gives
that layer at batch 32.

Every case holds the result to the kernel's bar on the card
(`GROUPED_CONV_REL_TOL` of `chip_smoke.py`: the largest difference from the
plain fp32 version within 2e-4 of the result's largest magnitude).  3xTF32
flushed per k-chunk passes it under either rounding; one product of the big
halves alone (plain TF32) must fail it, so a kernel that dropped the small
terms would not pass either.  Against the exact sum, truncating sums carried
over a whole part drift well past the flushed ones.
"""

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import grouped_conv as gk

REL_TOL = 2e-4  # chip_smoke.GROUPED_CONV_REL_TOL, unchanged from the FMA kernel
# one group of the (128, 128, 2, 4) layer at scale 1: (B, W, Cg, Og, k, s, pad)
SHAPE = (2, 4097, 32, 32, 41, 2, 20)
ITEM = 64        # positions of one item (`kDwTile`)
CHUNK = 8        # positions of one k-chunk
WARPS, MT, NT = 4, 4, 4  # `kDwWarps` and `dw_tiles` at 32 output channels
TARGET_BLOCKS = 8 * 132  # `kDwTargetBlocks`


def dw_items_per_part(batch: int, wout: int, pairs: int, groups: int, og: int) -> int:
    """Items a part walks, as `dw_parts` of csrc/grouped_conv.cu counts them."""
    bm, bn = WARPS * MT * 16, NT * 8
    base = -(-pairs // bm) * groups * -(-og // bn)
    total = batch * -(-wout // ITEM)
    parts = min(max(-(-TARGET_BLOCKS // base), 1), total)
    return -(-total // parts)


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """fp32 -> the nearest TF32 value, ties away from zero, as fp32."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def to_fp32(v: np.ndarray, toward_zero: bool) -> np.ndarray:
    """fp64 -> fp32, to nearest or toward zero."""
    out = v.astype(np.float32)
    if toward_zero:
        bits = out.view(np.uint32)
        bits -= (np.abs(out.astype(np.float64)) > np.abs(v)).astype(np.uint32)
    return out


def walk(x: np.ndarray, dy: np.ndarray):
    """(cols [pairs, P], dyc [P, Og], chunks per part): the contraction in the
    kernel's walk order, batch rows of items of 64 positions, each item's
    last k-chunk filled with zeros past the row's width, so that k-chunk i is
    columns 8 i .. 8 i + 7; parts of `dw_items_per_part` items at batch 32."""
    batch, width, cg, og, k, s, pad = SHAPE
    wout = dy.shape[2]
    padded = np.pad(x, ((0, 0), (0, 0), (pad, pad)))
    taps = np.lib.stride_tricks.sliding_window_view(padded, k, axis=2)[:, :, ::s]  # [b, c, n, j]
    cols, dys, chunks_of_item = [], [], []
    for b in range(batch):
        for n0 in range(0, wout, ITEM):
            n = min(ITEM, wout - n0)
            fill = -n % CHUNK
            block = taps[b, :, n0:n0 + n].transpose(0, 2, 1).reshape(cg * k, n)
            cols.append(np.pad(block, ((0, 0), (0, fill))))
            dys.append(np.pad(dy[b, :, n0:n0 + n].T, ((0, fill), (0, 0))))
            chunks_of_item.append((n + fill) // CHUNK)
    per = dw_items_per_part(32, wout, cg * k, 4, og)
    parts = [sum(chunks_of_item[i:i + per]) for i in range(0, len(chunks_of_item), per)]
    return np.concatenate(cols, axis=1), np.concatenate(dys, axis=0), parts


def emulate_kernel(cols, dyc, parts, three_terms: bool, toward_zero: bool,
                   flushed: bool = True) -> np.ndarray:
    """[pairs, Og] as the kernel sums it (see the module note).  Unflushed,
    one accumulator carries a part's whole walk."""
    a_big, b_big = tf32_rna(cols), tf32_rna(dyc)
    a_small, b_small = tf32_rna(cols - a_big), tf32_rna(dyc - b_big)
    terms = ((a_small, b_big), (a_big, b_small), (a_big, b_big)) if three_terms else (
        (a_big, b_big),)
    n_chunks = cols.shape[1] // CHUNK

    def chunk_products(lo, hi):
        """[hi - lo, pairs, Og] exact products of each term over chunks lo..hi."""
        out = []
        for a, b in terms:
            a3 = a[:, lo * CHUNK:hi * CHUNK].astype(np.float64).reshape(a.shape[0], hi - lo, CHUNK)
            b3 = b[lo * CHUNK:hi * CHUNK].astype(np.float64).reshape(hi - lo, CHUNK, b.shape[1])
            out.append(np.einsum("pcq,cqo->cpo", a3, b3))
        return out

    sums, start = [], 0
    for length in parts:
        acc = np.zeros((cols.shape[0], dyc.shape[1]), np.float32)
        for lo in range(start, start + length, 64):
            hi = min(lo + 64, start + length)
            products = chunk_products(lo, hi)
            if flushed:
                fresh = np.zeros((hi - lo, *acc.shape), np.float32)
                for p in products:
                    fresh = to_fp32(fresh.astype(np.float64) + p, toward_zero)
                for c in range(hi - lo):
                    acc = acc + fresh[c]
            else:
                for c in range(hi - lo):
                    for p in products:
                        acc = to_fp32(acc.astype(np.float64) + p[c], toward_zero)
        sums.append(acc)
        start += length
    assert start == n_chunks
    total = np.zeros_like(sums[0])
    for acc in sums:  # `dw_reduce_kernel`: parts in part order
        total = total + acc
    return total


@pytest.fixture(scope="module")
def case():
    """(cols, dyc, parts, the plain fp32 result [pairs, Og]) from seed 0."""
    batch, width, cg, og, k, s, pad = SHAPE
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, cg, width)).astype(np.float32)
    dy = rng.standard_normal((batch, og, gk.out_len(width, k, s, pad))).astype(np.float32)
    want = gk.grouped_conv_dw_plain(torch.from_numpy(x), torch.from_numpy(dy), k, s, pad, 1)
    want = want.numpy().reshape(og, cg * k).T
    cols, dyc, parts = walk(x, dy)
    return cols, dyc, parts, want


def test_walk_is_the_contraction_in_parts(case):
    cols, dyc, parts, want = case
    assert len(parts) >= 2 and sum(parts) * CHUNK == cols.shape[1]
    np.testing.assert_allclose(cols.astype(np.float64) @ dyc.astype(np.float64), want,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize(
    "three_terms, toward_zero",
    [(True, False), (True, True), (False, False)],
    ids=["3xtf32_flushed", "3xtf32_truncating_flushed", "1xtf32"])
def test_tf32_emulation_against_the_fp32_bar(case, three_terms, toward_zero):
    cols, dyc, parts, want = case
    got = emulate_kernel(cols, dyc, parts, three_terms, toward_zero)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if three_terms:
        assert rel <= REL_TOL, rel
    else:
        assert rel > REL_TOL, f"plain TF32 passes the bar ({rel}): the test cannot tell"


def test_truncating_sums_carried_over_a_part_drift(case):
    """Against the exact sum, the kernel's order (truncating `mma`, flushed
    per k-chunk) errs within 4x of plain fp32's own error; one truncating
    accumulator carried over each part's walk errs over 4x the flushed
    order's."""
    cols, dyc, parts, want = case
    exact = cols.astype(np.float64) @ dyc.astype(np.float64)

    def err(v):
        return float(np.abs(v - exact).max() / np.abs(exact).max())

    fp32 = err(want)
    flushed = err(emulate_kernel(cols, dyc, parts, True, toward_zero=True))
    carried = err(emulate_kernel(cols, dyc, parts, True, toward_zero=True, flushed=False))
    assert flushed <= 4 * fp32, (flushed, fp32)
    assert carried > 4 * flushed, (carried, flushed)
