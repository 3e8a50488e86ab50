"""The arithmetic of the K3 kernel (grouped conv forward and dX on the tensor
cores, 3xTF32), emulated in numpy on the CPU.

`csrc/grouped_conv.cu` rounds every fp32 operand v to TF32 with
`cvt.rna.tf32.f32` (round to nearest, ties away from zero, 10 mantissa bits)
as big = tf32(v) and small = tf32(v - big), and forms, per k-chunk of 8
(channel, tap) pairs, small.big, then big.small, then big.big in a fresh
accumulator (`mma.sync.m16n8k8`), which one fp32 add rounded to nearest puts
into the thread's sum.  The emulation forms each chunk's products exactly and
rounds once per `mma`, as the tensor core adds its products to the
accumulator, on one production-like contraction of the multi-scale
discriminator (64 channels x 41 taps, stride 4, 64 output channels).  The
`mma` rounding is to nearest, or toward zero: the H100's tensor cores read
about 2.4e-5 of the scale at a contraction of this length when one
accumulator carries the whole sum, where round-to-nearest reads 1e-6, and
truncating the accumulator reproduces that.  Flushed per k-chunk, the
truncation touches 24 products at a time and the sum stays at fp32's level.

Every case holds the result to the kernel's bar on the card
(`GROUPED_CONV_REL_TOL` of `chip_smoke.py`: the largest difference from the
plain fp32 version within 2e-4 of the result's largest magnitude).  3xTF32
passes it under either rounding; one product of the big halves alone (plain
TF32) must fail it, so a kernel that dropped the small terms would not pass
either.
"""

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import grouped_conv as gk

REL_TOL = 2e-4  # chip_smoke.GROUPED_CONV_REL_TOL, unchanged from the fp32 kernel
# (B, W, cin, cout, k, s, g, pad): one group of the discriminator's last
# strided layer at 256 output positions
SHAPE = (1, 1021, 64, 64, 41, 4, 1, 20)


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """fp32 -> the nearest TF32 value, ties away from zero, as fp32: the
    int32 view with 0x1000 added to the 13 dropped bits, then cleared."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def to_fp32(v: np.ndarray, toward_zero: bool) -> np.ndarray:
    """fp64 -> fp32, to nearest or toward zero."""
    out = v.astype(np.float32)
    if toward_zero:
        bits = out.view(np.uint32)
        bits -= (np.abs(out.astype(np.float64)) > np.abs(v)).astype(np.uint32)
    return out


def emulate_kernel(cols: np.ndarray, wmat: np.ndarray, three_terms: bool,
                   toward_zero: bool = False, flushed: bool = False) -> np.ndarray:
    """cols [P, K] (the input window, positions x (channel, tap)), wmat [K, N]
    -> [P, N] as the kernel sums it: k-chunks of 8 in (channel, tap) order,
    per chunk the cross terms and then big.big, each `mma` one rounding of
    (accumulator + exact chunk sum) to fp32.  `flushed`: each chunk's
    products go into a fresh accumulator, added to the sum in fp32."""
    a_big, b_big = tf32_rna(cols), tf32_rna(wmat)
    a_small, b_small = tf32_rna(cols - a_big), tf32_rna(wmat - b_big)
    terms = ((a_small, b_big), (a_big, b_small), (a_big, b_big)) if three_terms else (
        (a_big, b_big),)
    total = np.zeros((cols.shape[0], wmat.shape[1]), np.float32)
    acc = total
    for k0 in range(0, cols.shape[1], 8):
        if flushed:
            acc = np.zeros_like(total)
        for a, b in terms:
            part = a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8].astype(np.float64)
            acc = to_fp32(acc.astype(np.float64) + part, toward_zero)
        if flushed:
            total = total + acc
    return total if flushed else acc


def _production_case():
    """(cols, wmat, the plain fp32 result) of SHAPE, from seed 0."""
    b, width, cin, cout, k, s, g, pad = SHAPE
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, cin, width)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, k)) / np.sqrt(cin * k)).astype(np.float32)
    want = gk.grouped_conv_fwd_plain(torch.from_numpy(x), torch.from_numpy(w), s, pad, g)
    want = want[0].numpy().T  # [positions, output channels]
    padded = np.pad(x[0], ((0, 0), (pad, pad)))
    taps = np.lib.stride_tricks.sliding_window_view(padded, k, axis=1)[:, ::s]  # [c, n, j]
    cols = np.ascontiguousarray(taps.transpose(1, 0, 2).reshape(want.shape[0], cin * k))
    return cols, np.ascontiguousarray(w.reshape(cout, cin * k).T), want


@pytest.mark.parametrize(
    "three_terms, toward_zero, flushed",
    [(True, False, False), (True, True, False), (True, True, True), (False, False, False)],
    ids=["3xtf32", "3xtf32_truncating", "3xtf32_truncating_flushed", "1xtf32"])
def test_tf32_emulation_against_the_fp32_bar(three_terms, toward_zero, flushed):
    cols, wmat, want = _production_case()
    got = emulate_kernel(cols, wmat, three_terms, toward_zero, flushed)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if three_terms:
        assert rel <= REL_TOL, rel
    else:
        assert rel > REL_TOL, f"plain TF32 passes the bar ({rel}): the test cannot tell"


def test_flushed_truncating_sums_stay_at_fp32_level():
    """Against the exact sum, the kernel's order (truncating `mma`, flushed
    per k-chunk) errs within 4x of plain fp32's own error; carrying the
    truncating accumulator over the whole contraction errs over 20x."""
    cols, wmat, want = _production_case()
    exact = cols.astype(np.float64) @ wmat.astype(np.float64)

    def err(v):
        return float(np.abs(v - exact).max() / np.abs(exact).max())

    fp32 = err(want)
    flushed = err(emulate_kernel(cols, wmat, True, toward_zero=True, flushed=True))
    carried = err(emulate_kernel(cols, wmat, True, toward_zero=True))
    assert flushed <= 4 * fp32, (flushed, fp32)
    assert carried > 20 * fp32, (carried, fp32)
