"""The bf16 grouped-conv kernel K3 (forward and dX) in plain torch: its layout
pass, weight pack, contraction and order of sums, without the card.

csrc/grouped_conv.cu runs a bf16 K3 call as a stride-1 correlation over a
folded, channels-last copy of its input (`bf16_view`, `fold_bf16_kernel`)
with weights packed in the same channel order (`pack_w_bf16_kernel`), one
implicit GEMM over flat rows (`conv_bf16_kernel`).  This file writes the same
index maths as plain torch and holds:

- the contraction of the folded input with the packed weights, in fp64 on
  integer-valued data (every sum exact), equal to `grouped_conv_fwd_plain` and
  `grouped_conv_dx_plain` at strides 1, 2 and 4, odd widths (a scale of 8193
  samples), short last layers (33), Cin/G 2 to 64, and the 9 small shape
  classes of the card's smoke run;
- a walk in the kernel's order (channel chunks, taps, k-steps of 16; each
  k-step's 16 exact products added to an fp32 sum; y and dX rounded once to
  bf16) at a production contraction, within the bf16 bars of
  tests/test_torch_grouped_conv_bf16.py, and the same walk with its taps
  shifted by one outside them.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from roar_tpu_torch.kernels import grouped_conv as gk

from test_torch_grouped_conv_bf16 import assert_bf16_close
from torch_threads import one_torch_thread  # noqa: F401

# csrc/grouped_conv.cu: what two blocks a SM may have (a ring of 3 stages
# and the epilogue tile) and the main kernel's tiles (positions, output
# channels) by output channels
TWO_BLOCK_SMEM = 228 * 1024 // 2 - 1024
STAGES = 3


def tiles(oc: int) -> tuple:
    return (512, 8) if oc <= 8 else (256, 16) if oc <= 16 else (256, 32) if oc <= 32 else (128, 64)


def view(shape, dx: bool) -> dict:
    """`bf16_view`: the folded input's geometry of a (B, W, cin, cout, k, s,
    g, pad) call."""
    b, width, cin, cout, k, s, g, pad = shape
    cg, og = cin // g, cout // g
    wout = gk.out_len(width, k, s, pad)
    v = {"B": b, "G": g, "dx": dx, "T": -(-k // s), "W": width, "Wout": wout, "k": k, "s": s,
         "pad": pad, "Cg": cg, "Og": og}
    if not dx:
        v.update(C=cg, win=width, st=s, off=pad, pl=0, L=wout + v["T"] - 1, OC=og, phases=1)
    else:
        v.update(C=og, win=wout, st=1, OC=cg, phases=s, pl=0)
        for r in range(s):
            taps = phase(v, r)["taps"]
            if taps > 0:
                v["pl"] = max(v["pl"], taps - 1 - (r + pad) // s)
        v["off"], v["L"] = v["pl"], 1
        for r in range(s):
            p = phase(v, r)
            if p["taps"] > 0:
                v["L"] = max(v["L"], p["base"] + p["nout"] + p["taps"] - 1)
    v["Kc"] = -(-v["C"] * v["st"] // 16) * 16
    return v


def phase(v: dict, r: int) -> dict:
    """`bf16_phase`: taps, the first folded row output 0 reads, outputs and
    first tap of phase r (dX: outputs m = q s + r)."""
    if not v["dx"]:
        return {"taps": v["T"], "base": 0, "nout": v["Wout"], "j0": 0}
    s, k, pad = v["s"], v["k"], v["pad"]
    j0, d = (r + pad) % s, (r + pad) // s
    taps = -(-(k - j0) // s) if j0 < k else 0
    return {"taps": taps, "base": v["pl"] - (taps - 1 - d), "nout": -(-(v["W"] - r) // s),
            "j0": j0}


def fold(inp: torch.Tensor, v: dict) -> torch.Tensor:
    """The layout pass: [B, G C, win] -> [G, B L, Kc], folded row m of batch
    row b holding in[b, g C + c, m st + ph - off] at channel c st + ph, zero
    outside the width and past C st."""
    b, st, L = v["B"], v["st"], v["L"]
    pos = torch.arange(L)[:, None] * st + torch.arange(st)[None, :] - v["off"]  # [L, st]
    valid = (pos >= 0) & (pos < v["win"])
    x = inp.reshape(b, v["G"], v["C"], v["win"])[..., pos.clamp(0, v["win"] - 1)]
    x = x * valid  # [B, G, C, L, st]
    x = x.permute(1, 0, 3, 2, 4).reshape(v["G"], b, L, v["C"] * st)
    return F.pad(x, (0, v["Kc"] - v["C"] * st)).reshape(v["G"], b * L, v["Kc"])


def pack_w(w: torch.Tensor, v: dict) -> torch.Tensor:
    """The weight pack: [Cout, Cin/G, k] -> [phases, G, OC, T, Kc]; forward
    wp[0, g, o, t, c s + ph] = w[g Og + o, c, t s + ph], dX phase r
    wp[r, g, c, u, o] = w[g Og + o, c, j0 + s (taps - 1 - u)]; zero past the
    taps and channels."""
    g, og, cg, k, s, T, Kc = v["G"], v["Og"], v["Cg"], v["k"], v["s"], v["T"], v["Kc"]
    wg = w.reshape(g, og, cg, k)
    if not v["dx"]:
        wp = F.pad(wg, (0, T * s - k)).reshape(g, og, cg, T, s).permute(0, 1, 3, 2, 4)
        return F.pad(wp.reshape(g, og, T, cg * s), (0, Kc - cg * s))[None]
    wp = w.new_zeros((s, g, cg, T, Kc))
    for r in range(s):
        p = phase(v, r)
        for u in range(p["taps"]):
            wp[r, :, :, u, :og] = wg[:, :, :, p["j0"] + s * (p["taps"] - 1 - u)].transpose(1, 2)
    return wp


def stage_channels(v: dict) -> int:
    """`bf16_stages`: the channels a stage of the main kernel holds."""
    bm, bn = tiles(v["OC"])
    budget = (TWO_BLOCK_SMEM - 2 * bn * (bm + 8)) // STAGES
    best = None
    for ck in (64, 32, 16):
        if v["Kc"] % ck:
            continue
        tmax = min(v["T"], (budget // (2 * (ck + 8)) - bm + 1) // (1 + bn))
        if tmax < 1:
            continue
        groups = -(-v["T"] // tmax)
        tg = -(-v["T"] // groups)
        cost = v["Kc"] // ck * groups * ((bm + tg - 1) * ck + 2048)
        if best is None or cost < best[0]:
            best = (cost, ck)
    return best[1]


def contract(xf: torch.Tensor, wp: torch.Tensor, v: dict, walk: bool = False,
             shift: int = 0) -> torch.Tensor:
    """Output row p of phase r is sum_u xf[g, p + base + u] . wp[r, g, n, u]
    over flat rows p = b L + q (rows past B L read zeros), kept where
    q < nout, stored channels-first at position q (dX: q s + r).  With
    `walk`, the sums in the kernel's order: channel chunks of the stage size,
    taps, k-steps of 16, each k-step's 16 exact products added to an fp32
    sum, the result rounded once to bf16.  `shift` rolls the taps (a wrong
    tap)."""
    b, g, L, oc, Kc = v["B"], v["G"], v["L"], v["OC"], v["Kc"]
    dx, s = v["dx"], v["s"]
    out = xf.new_zeros((b, g * oc, v["W"] if dx else v["Wout"]))
    if walk:
        out = out.float()
    rows = b * L
    for r in range(v["phases"]):
        p = phase(v, r)
        taps, base = p["taps"], p["base"]
        xpad = F.pad(xf, (0, 0, 0, base + taps))
        w_r = wp[r].roll(shift, dims=2) if shift else wp[r]
        if not walk:
            acc = sum(torch.einsum("gpk,gnk->gpn", xpad[:, base + u:base + u + rows], w_r[:, :, u])
                      for u in range(taps)) if taps else xf.new_zeros((g, rows, oc))
        else:
            ck = stage_channels(v)
            acc = torch.zeros((g, rows, oc), dtype=torch.float32)
            for c0 in range(0, Kc, ck):
                for u in range(taps):
                    for k0 in range(c0, c0 + ck, 16):
                        step = torch.einsum("gpk,gnk->gpn",
                                            xpad[:, base + u:base + u + rows, k0:k0 + 16].double(),
                                            w_r[:, :, u, k0:k0 + 16].double())
                        acc = (acc.double() + step).float()
        acc = acc.reshape(g, b, L, oc)[:, :, :p["nout"]].permute(1, 0, 3, 2)
        if dx:
            out[:, :, r::s] = acc.reshape(b, g * oc, -1).to(out.dtype)
        else:
            out[:] = acc.reshape(b, g * oc, -1).to(out.dtype)
    return out.to(torch.bfloat16) if walk else out


SMALL = [  # chip_smoke.GROUPED_CONV_SMALL, (B, W, cin, cout, k, s, g, pad)
    (2, 64, 8, 8, 5, 1, 4, 2), (2, 64, 8, 16, 5, 2, 4, 2), (2, 64, 16, 16, 9, 4, 4, 4),
    (2, 64, 8, 8, 5, 1, 1, 2), (2, 64, 8, 8, 5, 1, 4, 1), (1, 66, 8, 8, 9, 1, 2, 4),
    (3, 64, 8, 8, 41, 2, 4, 20), (2, 257, 16, 16, 9, 4, 4, 4), (2, 63, 12, 6, 5, 3, 2, 1),
]
LAYERS = [  # the multi-scale discriminator's grouped layers, narrowed in batch and width
    (2, 8193, 8, 16, 41, 2, 4, 20),     # Cin/G 2, stride 2, odd width (scale 1's first)
    (1, 4097, 32, 64, 41, 4, 2, 20),    # Cin/G 16, stride 4, odd width
    (2, 129, 64, 128, 41, 4, 2, 20),    # Cin/G 32, stride 4
    (2, 33, 128, 128, 41, 1, 2, 20),    # Cin/G 64, stride 1, a short last layer
    (1, 65, 128, 64, 41, 2, 4, 20),     # Cin/G 32, Og 16, stride 2
    (1, 30, 6, 12, 3, 4, 3, 1),         # k < s: a dX phase no tap reaches
]
SHAPES = LAYERS + SMALL


def _integers(shape, seed):
    """x, w and dy of a call as fp64 integers: every product and sum exact."""
    b, width, cin, cout, k, s, g, pad = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-8, 9, (b, cin, width)).astype(np.float64))
    w = torch.from_numpy(rng.integers(-8, 9, (cout, cin // g, k)).astype(np.float64))
    dy = torch.from_numpy(rng.integers(-8, 9, (b, cout, gk.out_len(width, k, s, pad)))
                          .astype(np.float64))
    return x, w, dy


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_folded_contraction_is_the_forward(shape):
    b, width, cin, cout, k, s, g, pad = shape
    x, w, _ = _integers(shape, 0)
    v = view(shape, dx=False)
    xf = fold(x, v)
    assert xf.shape == (g, b * v["L"], v["Kc"]) and v["Kc"] % 16 == 0
    got = contract(xf, pack_w(w, v), v)
    assert torch.equal(got, gk.grouped_conv_fwd_plain(x, w, s, pad, g))


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_folded_contraction_is_the_input_gradient(shape):
    b, width, cin, cout, k, s, g, pad = shape
    _, w, dy = _integers(shape, 1)
    v = view(shape, dx=True)
    assert all(phase(v, r)["base"] >= 0 for r in range(s))
    got = contract(fold(dy, v), pack_w(w, v), v)
    assert torch.equal(got, gk.grouped_conv_dx_plain(dy, w, width, s, pad, g))


# one production contraction: Cin/G 64, Og 64, k 41, stride 4 (K 11 x 256 in
# the forward, 11 x 64 per dX phase)
WALK = (1, 1021, 64, 64, 41, 4, 1, 20)


def _bf16_inputs(shape, seed):
    b, width, cin, cout, k, s, g, pad = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cin, width)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, cin // g, k)) / np.sqrt(k * cin // g))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, cout, gk.out_len(width, k, s, pad)))
                          .astype(np.float32))
    return x.bfloat16(), w.bfloat16(), dy.bfloat16()


@pytest.mark.parametrize("dx", [False, True], ids=["fwd", "dx"])
def test_walk_in_the_kernel_order_passes_the_bf16_bars(dx):
    b, width, cin, cout, k, s, g, pad = WALK
    x, w, dy = _bf16_inputs(WALK, 2)
    v = view(WALK, dx)
    got = contract(fold(dy if dx else x, v), pack_w(w, v), v, walk=True)
    want = (gk.grouped_conv_dx_plain(dy, w, width, s, pad, g) if dx
            else gk.grouped_conv_fwd_plain(x, w, s, pad, g))
    assert got.dtype == want.dtype == torch.bfloat16
    assert_bf16_close(got.float().numpy(), want.float().numpy(), "dx" if dx else "y")


@pytest.mark.parametrize("dx", [False, True], ids=["fwd", "dx"])
def test_walk_with_a_shifted_tap_fails_the_bf16_bars(dx):
    b, width, cin, cout, k, s, g, pad = WALK
    x, w, dy = _bf16_inputs(WALK, 3)
    v = view(WALK, dx)
    got = contract(fold(dy if dx else x, v), pack_w(w, v), v, walk=True, shift=1)
    want = (gk.grouped_conv_dx_plain(dy, w, width, s, pad, g) if dx
            else gk.grouped_conv_fwd_plain(x, w, s, pad, g))
    with pytest.raises(AssertionError, match="over the bar"):
        assert_bf16_close(got.float().numpy(), want.float().numpy(), "dx" if dx else "y")
