"""The bf16 grouped-conv weight gradient K4 in plain torch: its two layout
passes, its contraction over flat rows split into parts, its unpack and its
order of sums, without the card.

csrc/grouped_conv.cu runs a bf16 dW call (`run_dw_bf16`) as a GEMM per group
over the flat rows of two folded, channels-last inputs: x folded with the
forward's view (x'[g][b L + m][c s + ph] = x[b][g Cg + c][m s + ph - pad],
L = Wout + T - 1) and dy folded to the same rows (dy'[g][b L + n][o] =
dy[b][g Og + o][n], zero at n >= Wout).  `dw_bf16_kernel` forms
dWf[g][o][t][cf] = sum_p dy'[p][o] x'[p + t][cf] over the rows of one part in
k-steps of 16, and `dw_unpack_bf16_kernel` adds the parts in part order and
writes dw[g Og + o][c][t s + ph] = dWf[g][o][t][c s + ph].  This file writes
the same index maths as plain torch and holds:

- the folded contraction and unpack, in fp64 on integer-valued data (every
  sum exact), equal to `grouped_conv_dw_plain` at strides 1 to 4, odd widths
  (8193 at a narrow channel count), short last layers (65, 129), Cin/G 2 to
  64, and the 9 small shape classes of the card's smoke run;
- at one small shape, the walk against the dW of the JAX package's
  `grouped_conv1d_cf` VJP in interpret mode;
- a walk in the kernel's order (each part's rows in k-steps of 16, each
  k-step's 16 exact products added to an fp32 sum, the parts added in part
  order in fp32) at a production contraction, within the bf16 bars of
  tests/test_torch_grouped_conv_bf16.py, and the same walk without dy's zero
  tail, or with a tap shifted by one, outside them.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from roar_tpu_torch.kernels import grouped_conv as gk

from test_torch_grouped_conv_bf16 import _inputs, _jax_bf16, _torch_weight, assert_bf16_close
from test_torch_grouped_conv_bf16_walk import SMALL, fold, view
from torch_threads import one_torch_thread  # noqa: F401

# csrc/grouped_conv.cu: flat rows a stage, the blocks the parts aim at (two
# waves of two blocks on 132 SMs), the stages a part walks at the least
BK = 128
BLOCKS = 4 * 132
MIN_STAGES = 8


def dy_view(v: dict, og: int, wout: int) -> dict:
    """dy's fold: the forward view's rows, Og channels, stride 1, no offset."""
    return dict(v, C=og, win=wout, st=1, off=0, Kc=-(-og // 16) * 16)


def plan(shape) -> dict:
    """`dw_bf16_plan`: the main kernel's tiles (m-tiles and output channels a
    block by Og), the channel chunks and taps a block, and the parts."""
    b, width, cin, cout, k, s, g, pad = shape
    v = view(shape, dx=False)
    T, Kx, og = v["T"], v["Kc"], cout // g
    mb, bn = (32, 16) if og <= 16 else (32, 32) if og <= 32 else (16, 64)
    best = None
    for cq in (4, 2, 1):
        if (Kx // 16) % cq:
            continue
        tmax = mb // cq
        groups = -(-T // tmax)
        tg = -(-T // groups)
        blocks = groups * (Kx // (16 * cq))
        cost = blocks * (16 * BK * mb + 16 * cq * (BK + tg - 1) + BK * bn)
        if best is None or cost < best[0]:
            best = (cost, cq, tg, groups)
    _, cq, tg, groups = best
    stages = -(-b * v["L"] // BK)
    base = groups * (Kx // (16 * cq)) * g * -(-og // bn)
    parts = min(-(-BLOCKS // base), max(1, stages // MIN_STAGES))
    per = -(-stages // parts)
    return {"cq": cq, "tg": tg, "tgroups": groups, "stages": stages, "per_part": per,
            "parts": -(-stages // per)}


def folds(x: torch.Tensor, dy: torch.Tensor, shape) -> tuple:
    """x' [G, B L, Kx] and dy' [G, B L, Kd] of a call."""
    b, width, cin, cout, k, s, g, pad = shape
    v = view(shape, dx=False)
    return fold(x, v), fold(dy, dy_view(v, cout // g, v["Wout"])), v


def contract(xf: torch.Tensor, dyf: torch.Tensor, taps: int, shift: int = 0) -> torch.Tensor:
    """dWf[g, o, t, cf] = sum over flat rows p of dy'[g, p, o] x'[g, p + t + shift, cf]
    (rows past B L read zeros); `shift` 1 is a wrong tap."""
    rows = xf.shape[1]
    xpad = F.pad(xf, (0, 0, 0, taps + shift))
    return torch.stack([torch.einsum("gpo,gpc->goc", dyf, xpad[:, t + shift:t + shift + rows])
                        for t in range(taps)], dim=2)


def unpack(dwf: torch.Tensor, shape) -> torch.Tensor:
    """dw[g Og + o, c, j] = dWf[g, o, j // s, c s + j % s] -> [Cout, Cin/G, k]
    (dWf's output channels past Og, dy' padding, dropped)."""
    b, width, cin, cout, k, s, g, pad = shape
    j, c = torch.arange(k), torch.arange(cin // g)
    picked = dwf[:, :cout // g, (j // s)[None, :], c[:, None] * s + (j % s)[None, :]]
    return picked.reshape(cout, cin // g, k)


def walk(xf: torch.Tensor, dyf: torch.Tensor, taps: int, p: dict, shift: int = 0,
         chunk: int = 128) -> torch.Tensor:
    """dWf of one group (x' [B L, Kx], dy' [B L, Kd]) in the kernel's order:
    each part's rows in k-steps of 16, each k-step's 16 exact products (fp64)
    added to an fp32 sum; the parts' sums added in part order in fp32."""
    rows, kx = xf.shape
    og = dyf.shape[1]
    length = p["stages"] * BK
    dyp = F.pad(dyf.double(), (0, 0, 0, length - rows))
    xpad = F.pad(xf.double(), (0, 0, 0, length - rows + taps + shift))
    windows = xpad[shift:].unfold(0, taps, 1)  # [rows, Kx, T]: row p holds x'[p + t + shift]
    total = torch.zeros((og, kx, taps), dtype=torch.float32)
    for part in range(p["parts"]):
        acc = torch.zeros((og, kx, taps), dtype=torch.float32)
        p0 = part * p["per_part"] * BK
        p1 = min(p0 + p["per_part"] * BK, length)
        for c0 in range(p0, p1, chunk * 16):
            c1 = min(c0 + chunk * 16, p1)
            steps = torch.einsum("sio,sict->soct", dyp[c0:c1].reshape(-1, 16, og),
                                 windows[c0:c1].reshape(-1, 16, kx, taps))
            for step in steps:
                acc = (acc.double() + step).float()
        total = total + acc
    return total.permute(0, 2, 1)  # [O, T, Kx]


def _integers(shape, seed):
    """x and dy of a call as fp64 integers: every product and sum exact."""
    b, width, cin, cout, k, s, g, pad = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-8, 9, (b, cin, width)).astype(np.float64))
    dy = torch.from_numpy(rng.integers(-8, 9, (b, cout, gk.out_len(width, k, s, pad)))
                          .astype(np.float64))
    return x, dy


LAYERS = [  # the multi-scale discriminator's grouped layers, narrowed in batch and width
    (2, 8193, 8, 16, 41, 2, 4, 20),     # Cin/G 2, stride 2, odd width (scale 1's first)
    (1, 4097, 32, 64, 41, 4, 2, 20),    # Cin/G 16, stride 4, odd width
    (2, 129, 64, 128, 41, 4, 2, 20),    # Cin/G 32, stride 4, a short last layer
    (2, 65, 128, 128, 41, 1, 2, 20),    # Cin/G 64, stride 1, a short last layer
    (1, 65, 128, 64, 41, 2, 4, 20),     # Cin/G 32, Og 16, stride 2
    (2, 100, 12, 24, 7, 3, 2, 3),       # stride 3
    (1, 30, 6, 12, 3, 4, 3, 1),         # k < s: taps of one phase only
]
SHAPES = LAYERS + SMALL


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_folded_contraction_is_the_weight_gradient(shape):
    b, width, cin, cout, k, s, g, pad = shape
    x, dy = _integers(shape, 0)
    xf, dyf, v = folds(x, dy, shape)
    assert xf.shape == (g, b * v["L"], v["Kc"]) and dyf.shape[:2] == xf.shape[:2]
    assert dyf.shape[2] % 16 == 0
    # dy's fold is zero on the rows past each batch row's outputs
    tail = dyf.reshape(g, b, v["L"], -1)[:, :, v["Wout"]:]
    assert tail.numel() == g * b * (v["T"] - 1) * dyf.shape[2] and not tail.any()
    got = unpack(contract(xf, dyf, v["T"]), shape)
    assert torch.equal(got, gk.grouped_conv_dw_plain(x, dy, k, s, pad, g))


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_parts_cover_the_rows_once(shape):
    p = plan(shape)
    assert p["parts"] >= 1 and (p["parts"] - 1) * p["per_part"] < p["stages"]
    assert p["parts"] * p["per_part"] >= p["stages"]
    assert p["tg"] * p["tgroups"] >= view(shape, dx=False)["T"]


def test_walk_matches_the_jax_vjp_in_interpret_mode():
    shape = (2, 96, 64, 64, 41, 2, 2, 20)  # Cin/G 32, stride 2
    b, width, cin, cout, k, s, g, pad = shape
    x, w, cot = _inputs(shape, 5)
    _, _, (dw_j, t_dw) = _jax_bf16(x, w, cot, s, pad, g, "float32")
    assert t_dw == "float32"
    xt, dyt = torch.from_numpy(x).bfloat16(), torch.from_numpy(cot).bfloat16()
    xf, dyf, v = folds(xt, dyt, shape)
    p = plan(shape)
    dwf = torch.stack([walk(xf[i], dyf[i], v["T"], p) for i in range(g)])
    got = unpack(dwf, shape)
    assert got.dtype == torch.float32
    want = _torch_weight(dw_j, torch.float32)
    assert_bf16_close(got.numpy().reshape(cout, -1), want.numpy().reshape(cout, -1), "dw")


# one production contraction: the first grouped layer of the discriminator at
# HiFi-GAN's 32 x 8192 (Cin/G 32, Og 32, stride 2: K 21 x 64 folded pairs,
# 131,712 flat rows), walked for its first group in the plan of the whole
# layer (43 parts)
WALK = (32, 8192, 128, 128, 41, 2, 4, 20)


def _walk_case(seed: int) -> tuple:
    """Group 0 of WALK: x' and dy' folded from seeded bf16 values, the plan of
    the whole layer, and the plain dW of the group's 32 output channels (in
    batch chunks, so the unfolded taps fit memory)."""
    b, width, cin, cout, k, s, g, pad = WALK
    cg, og = cin // g, cout // g
    one = (b, width, cg, og, k, s, 1, pad)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cg, width), dtype=np.float32)).bfloat16()
    dy = torch.from_numpy(rng.standard_normal((b, og, gk.out_len(width, k, s, pad)),
                                              dtype=np.float32)).bfloat16()
    xf, dyf, v = folds(x, dy, one)
    want = sum(gk.grouped_conv_dw_plain(xc, dyc, k, s, pad, 1)
               for xc, dyc in zip(x.split(4), dy.split(4)))
    return xf[0], dyf[0], v, plan(WALK), want, one


def test_walk_in_the_kernel_order_passes_the_bf16_bars():
    xf, dyf, v, p, want, one = _walk_case(6)
    assert p["parts"] > 1
    got = unpack(walk(xf, dyf, v["T"], p)[None], one)
    assert_bf16_close(got.numpy().reshape(got.shape[0], -1),
                      want.numpy().reshape(want.shape[0], -1), "dw")


@pytest.mark.parametrize("fault", ["no_zero_tail", "shifted_tap"])
def test_walk_with_a_fault_fails_the_bf16_bars(fault):
    xf, dyf, v, p, want, one = _walk_case(7)
    if fault == "no_zero_tail":  # each batch row's tail holds dy's first positions again
        rows = dyf.reshape(-1, v["L"], dyf.shape[1]).clone()
        rows[:, v["Wout"]:] = rows[:, :v["L"] - v["Wout"]]
        dyf = rows.reshape(dyf.shape)
    got = unpack(walk(xf, dyf, v["T"], p, shift=int(fault == "shifted_tap"))[None], one)
    with pytest.raises(AssertionError, match="over the bar"):
        assert_bf16_close(got.numpy().reshape(got.shape[0], -1),
                          want.numpy().reshape(want.shape[0], -1), "dw")
