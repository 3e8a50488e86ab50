"""The bf16 form of the grouped 1-D conv (K3 forward and dX, K4 dW) against
the JAX package.

The port's plain versions (what a CPU tensor takes) and its autograd Function,
on bf16 inputs made from a numpy seed, against `grouped_conv1d_cf(...,
interpret=True)` and its `jax.vjp` on the same bf16 values: the Pallas
kernels' own bf16 arithmetic (bf16 operands, fp32 sums, y and dX written in
bf16, dW summed in fp32 and cast to the weight's type).  The shapes cover
every `Cin/G` of the multi-scale discriminator (8, 16, 32, 64; k 41, pad 20),
strides 1, 2 and 4, and odd widths (scales 1 and 2 of a segment have 8193 and
4097 samples).  The `cuda`-marked test holds the bf16 kernels against the
plain versions on the card and skips here; jax is imported inside the tests
that use it, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_grouped_conv_bf16.py -m cuda
"""

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import grouped_conv as gk
from roar_tpu_torch.ops.grouped_conv import grouped_conv1d_cf, out_len

from torch_threads import one_torch_thread  # noqa: F401

# bf16's bars (those of the bf16 flash kernels): every element within 2^-6 of
# its value plus 2^-7 of its row's largest magnitude (a row: one channel's
# width for y and dX, one output channel's Cin/G x k taps for dW), and the
# whole within 1e-2 relative L2.  Both sides sum the same bf16 products in
# fp32 and round once; what differs is the order of the sums and, where a
# sum lands near a rounding boundary, one bf16 step (2^-8 of the value)
ELEM_REL = 2.0 ** -6
ROW_REL = 2.0 ** -7
L2_REL = 1e-2

SHAPES = [
    # (B, W, cin, cout, k, s, g, pad)
    (2, 96, 64, 64, 41, 2, 2, 20),     # Cin/G 32, stride 2 (scale layers 1 and 4's Cin/G)
    (2, 96, 16, 32, 41, 2, 2, 20),     # Cin/G 8, stride 2
    (2, 129, 32, 64, 41, 4, 2, 20),    # Cin/G 16, stride 4, odd width
    (2, 65, 64, 128, 41, 4, 2, 20),    # Cin/G 32, stride 4, odd width
    (1, 33, 128, 128, 41, 1, 2, 20),   # Cin/G 64, stride 1, odd width
    (2, 64, 8, 8, 5, 1, 4, 2),         # the small class of tests/test_grouped_conv.py
]
IDS = [str(s) for s in SHAPES]


def _bf16_np(a: np.ndarray) -> np.ndarray:
    """float32 values that are bf16 numbers (torch's round to nearest even)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(shape, seed):
    """x [B, Cin, W], flax kernel [k, Cin/G, Cout] (scaled by 1/sqrt(fan in))
    and a cotangent [B, Cout, Wout], each a bf16 value held in float32."""
    b, wid, cin, cout, k, s, g, pad = shape
    rng = np.random.default_rng(seed)
    x = _bf16_np(rng.standard_normal((b, cin, wid)).astype(np.float32))
    w = _bf16_np((rng.standard_normal((k, cin // g, cout)) / np.sqrt(k * cin // g))
                 .astype(np.float32))
    cot = _bf16_np(rng.standard_normal((b, cout, out_len(wid, k, s, pad))).astype(np.float32))
    return x, w, cot


def _jax_bf16(x, w, cot, s, pad, g, w_dtype="bfloat16"):
    """(y, dx, dw) of the JAX op in interpret mode on bf16 x and cotangent,
    the kernel in `w_dtype`, each as float32 numpy with its dtype's name."""
    import jax
    import jax.numpy as jnp

    from roar_tpu.ops.grouped_conv import grouped_conv1d_cf as jax_conv

    xj = jnp.asarray(x, jnp.bfloat16)
    wj = jnp.asarray(w, getattr(jnp, w_dtype))
    y, vjp = jax.vjp(lambda a, b: jax_conv(a, b, s, pad, g, True), xj, wj)
    dx, dw = vjp(jnp.asarray(cot, jnp.bfloat16))
    return [(np.asarray(t.astype(jnp.float32)), str(t.dtype)) for t in (y, dx, dw)]


def _torch_weight(w: np.ndarray, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))).to(dtype)


def assert_bf16_close(got: np.ndarray, want: np.ndarray, what: str) -> dict:
    """The bars above; rows are the last axis of `got` and `want` as given."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    row_max = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want)
    excess = err - (ELEM_REL * np.abs(want) + ROW_REL * row_max)
    l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert excess.max() <= 0.0, (
        f"{what}: {int((excess > 0).sum())} elements over the bar, worst by {excess.max()}")
    assert l2 <= L2_REL, f"{what}: relative L2 {l2} > {L2_REL}"
    return {"l2": l2, "max_over_row": float((err / np.maximum(row_max, 1e-30)).max())}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bf16_plain_versions_match_the_pallas_kernels_in_interpret_mode(shape):
    b, wid, cin, cout, k, s, g, pad = shape
    x, w, cot = _inputs(shape, 0)
    (y_j, ty), (dx_j, tdx), (dw_j, tdw) = _jax_bf16(x, w, cot, s, pad, g)
    assert (ty, tdx, tdw) == ("bfloat16", "bfloat16", "bfloat16")
    xt, wt = torch.from_numpy(x).to(torch.bfloat16), _torch_weight(w)
    cott = torch.from_numpy(cot).to(torch.bfloat16)
    y = gk.grouped_conv_fwd_plain(xt, wt, s, pad, g)
    dx = gk.grouped_conv_dx_plain(cott, wt, wid, s, pad, g)
    dw = gk.grouped_conv_dw_plain(xt, cott, k, s, pad, g)
    # the TPU kernels' output types: y and dX bf16, dW fp32 (the op casts it)
    assert (y.dtype, dx.dtype, dw.dtype) == (torch.bfloat16, torch.bfloat16, torch.float32)
    assert_bf16_close(y.float().numpy(), y_j, "y")
    assert_bf16_close(dx.float().numpy(), dx_j, "dx")
    assert_bf16_close(dw.numpy().reshape(cout, -1), dw_j.transpose(2, 1, 0).reshape(cout, -1),
                      "dw")


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32], ids=["bf16_w", "fp32_w"])
@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[4]], ids=[IDS[2], IDS[4]])
def test_bf16_autograd_function_follows_the_jax_casts(shape, w_dtype):
    """y in x's type with the weight cast to it; dX in dy's type; dW in the
    weight's own type (roar_tpu/ops/grouped_conv.py:489-519)."""
    b, wid, cin, cout, k, s, g, pad = shape
    x, w, cot = _inputs(shape, 1)
    name = "bfloat16" if w_dtype == torch.bfloat16 else "float32"
    (y_j, ty), (dx_j, tdx), (dw_j, tdw) = _jax_bf16(x, w, cot, s, pad, g, name)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = _torch_weight(w, w_dtype).requires_grad_()
    y = grouped_conv1d_cf(xt, wt, s, pad, g)
    y.backward(torch.from_numpy(cot).to(torch.bfloat16))
    assert (str(y.dtype), str(xt.grad.dtype), str(wt.grad.dtype)) == (
        f"torch.{ty}", f"torch.{tdx}", f"torch.{tdw}")
    assert_bf16_close(y.detach().float().numpy(), y_j, "y")
    assert_bf16_close(xt.grad.float().numpy(), dx_j, "dx")
    assert_bf16_close(wt.grad.float().numpy().reshape(cout, -1),
                      dw_j.transpose(2, 1, 0).reshape(cout, -1), "dw")


def test_bf16_bar_sees_a_wrong_tap():
    """The bar is not blind at these shapes: the forward with its weight's
    taps shifted by one fails it."""
    b, wid, cin, cout, k, s, g, pad = SHAPES[0]
    x, w, cot = _inputs(SHAPES[0], 2)
    (y_j, _), _, _ = _jax_bf16(x, w, cot, s, pad, g)
    wrong = gk.grouped_conv_fwd_plain(torch.from_numpy(x).to(torch.bfloat16),
                                      _torch_weight(w).roll(1, dims=2), s, pad, g)
    with pytest.raises(AssertionError, match="over the bar"):
        assert_bf16_close(wrong.float().numpy(), y_j, "y")


def test_wrappers_reject_mixed_types_on_the_card_path():
    """A CUDA call checks that x, w (and dy) share one kernel type; on the
    meta device the check is reached without a card."""
    with pytest.raises(ValueError, match="no kernel for device"):
        gk.grouped_conv_fwd(torch.zeros(1, 8, 16, dtype=torch.bfloat16, device="meta"),
                            torch.zeros(8, 2, 5, device="meta"), 1, 2, 4)
    with pytest.raises(TypeError, match="same type"):
        gk._check_cuda("w", torch.zeros(8, 2, 5), torch.device("cpu"), torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gk._check_cuda("x", torch.zeros(2, dtype=torch.float16), torch.device("cpu"),
                       torch.float16)


@pytest.mark.cuda
def test_bf16_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    dev = torch.device("cuda")
    for shape in SHAPES:
        b, wid, cin, cout, k, s, g, pad = shape
        x, w, cot = _inputs(shape, 4)
        x = torch.from_numpy(x).to(dev, torch.bfloat16)
        cot = torch.from_numpy(cot).to(dev, torch.bfloat16)
        w = _torch_weight(w).to(dev)
        before = (gk.LAUNCHES_FWD_BF16, gk.LAUNCHES_DX_BF16, gk.LAUNCHES_DW_BF16)
        got = (gk.grouped_conv_fwd(x, w, s, pad, g), gk.grouped_conv_dx(cot, w, wid, s, pad, g),
               gk.grouped_conv_dw(x, cot, k, s, pad, g))
        assert (gk.LAUNCHES_FWD_BF16, gk.LAUNCHES_DX_BF16, gk.LAUNCHES_DW_BF16) == tuple(
            n + 1 for n in before)
        want = (gk.grouped_conv_fwd_plain(x, w, s, pad, g),
                gk.grouped_conv_dx_plain(cot, w, wid, s, pad, g),
                gk.grouped_conv_dw_plain(x, cot, k, s, pad, g))
        assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
        for name, a, e in zip(("y", "dx", "dw"), got, want):
            rows = a.float().cpu().numpy().reshape(-1, a.shape[-1] if name != "dw" else
                                                   a[0].numel())
            assert_bf16_close(rows, e.float().cpu().numpy().reshape(rows.shape), name)
        # fixed summation orders, no atomics: two runs give the same bits
        assert torch.equal(got[0], gk.grouped_conv_fwd(x, w, s, pad, g))
        assert torch.equal(got[1], gk.grouped_conv_dx(cot, w, wid, s, pad, g))
        assert torch.equal(got[2], gk.grouped_conv_dw(x, cot, k, s, pad, g))
        # contiguous views whose data start 2 bytes past a 16-byte boundary:
        # the layout passes read them element by element, to the same bits
        def off_by_one(t):
            return torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape).copy_(t)

        assert torch.equal(got[0], gk.grouped_conv_fwd(off_by_one(x), w, s, pad, g))
        assert torch.equal(got[1], gk.grouped_conv_dx(off_by_one(cot), w, wid, s, pad, g))
        assert torch.equal(got[2], gk.grouped_conv_dw(off_by_one(x), off_by_one(cot), k, s, pad,
                                                      g))
