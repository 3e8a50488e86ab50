"""Grouped 1-D conv of the port against the JAX package.

The port's plain forward, dX and dW (what a CPU tensor takes) and its
autograd Function against `grouped_conv1d_cf` in interpret mode (forward) and
against `jax.grad` of `lax.conv_general_dilated` (gradients; the JAX package's
own tests pin the Pallas kernel's VJP to that reference).  The one numpy
weight is flax's [k, Cin/G, Cout] on the JAX side and torch's [Cout, Cin/G, k]
on the port's.  jax is imported inside the tests that use it: the card's
machine, where the `cuda` test of this file runs, has none.
"""

import numpy as np
import pytest
import torch

from roar_tpu_torch.kernels import grouped_conv as gk
from roar_tpu_torch.ops.grouped_conv import GroupedConv1dCF, grouped_conv1d_cf, out_len

# fp32 on both sides; only the order of summation differs
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

SHAPES = [
    # (B, W, cin, cout, k, s, g, pad): the classes of tests/test_grouped_conv.py
    (2, 64, 8, 8, 5, 1, 4, 2),
    (2, 64, 8, 16, 5, 2, 4, 2),
    (2, 64, 16, 16, 9, 4, 4, 4),
    (2, 64, 8, 8, 5, 1, 1, 2),
    (2, 64, 8, 8, 5, 1, 4, 1),
    (1, 66, 8, 8, 9, 1, 2, 4),
    (3, 64, 8, 8, 41, 2, 4, 20),
    (2, 257, 16, 16, 9, 4, 4, 4),   # odd width, stride 4: tail positions with fewer taps
]
IDS = [str(s) for s in SHAPES]


def _jax_grads(x, w, cot, s, pad, g):
    """(dx, dw) of sum(conv(x, w) * cot) by `jax.grad` of the lax conv."""
    import jax
    import jax.numpy as jnp

    def loss(x, w):
        y = jax.lax.conv_general_dilated(
            x, w, window_strides=(s,), padding=[(pad, pad)], feature_group_count=g,
            dimension_numbers=("NCW", "WIO", "NCW"))
        return jnp.sum(y * cot)

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(gx), np.asarray(gw)


def _inputs(shape, seed):
    b, wid, cin, cout, k, s, g, pad = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin, wid)).astype(np.float32)
    w = (rng.standard_normal((k, cin // g, cout)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((b, cout, out_len(wid, k, s, pad))).astype(np.float32)
    return x, w, cot


def _torch_weight(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_matches_pallas_interpret(shape):
    import jax.numpy as jnp

    from roar_tpu.ops.grouped_conv import grouped_conv1d_cf as jax_grouped_conv1d_cf

    *_, s, g, pad = shape
    x, w, _ = _inputs(shape, 0)
    want = np.asarray(jax_grouped_conv1d_cf(jnp.asarray(x), jnp.asarray(w), s, pad, g, True))
    got = grouped_conv1d_cf(torch.from_numpy(x), _torch_weight(w), s, pad, g).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_dx_dw_match_jax_grad(shape):
    b, wid, cin, cout, k, s, g, pad = shape
    x, w, cot = _inputs(shape, 1)
    gx, gw = _jax_grads(x, w, cot, s, pad, g)
    dx = gk.grouped_conv_dx_plain(torch.from_numpy(cot), _torch_weight(w), wid, s, pad, g)
    dw = gk.grouped_conv_dw_plain(torch.from_numpy(x), torch.from_numpy(cot), k, s, pad, g)
    np.testing.assert_allclose(dx.numpy(), gx, **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy().transpose(2, 1, 0), gw, **GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_autograd_function_matches_jax_grad(shape):
    b, wid, cin, cout, k, s, g, pad = shape
    x, w, cot = _inputs(shape, 2)
    gx, gw = _jax_grads(x, w, cot, s, pad, g)
    xt = torch.from_numpy(x).requires_grad_()
    wt = _torch_weight(w).requires_grad_()
    (grouped_conv1d_cf(xt, wt, s, pad, g) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx, **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 1, 0), gw, **GRAD_TOL)


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4], (2, 21, 4, 6, 5, 4, 2, 1)],
                         ids=["stride2", "small_pad", "odd_width_stride4"])
def test_gradcheck_float64(shape):
    b, wid, cin, cout, k, s, g, pad = shape
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, cin, wid))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((cout, cin // g, k))).requires_grad_()
    assert torch.autograd.gradcheck(lambda x, w: GroupedConv1dCF.apply(x, w, s, pad, g), (x, w))


def test_backward_runs_only_the_gradients_asked_for(monkeypatch):
    calls = []
    monkeypatch.setattr(gk, "grouped_conv_dx", lambda *a: calls.append("dx") or torch.zeros(2, 8, 64))
    monkeypatch.setattr(gk, "grouped_conv_dw", lambda *a: calls.append("dw") or torch.zeros(8, 2, 5))
    x = torch.randn(2, 8, 64, requires_grad=True)
    w = torch.randn(8, 2, 5)
    grouped_conv1d_cf(x, w, 1, 2, 4).sum().backward()
    assert calls == ["dx"]  # a weight that needs no gradient: no dW
    calls.clear()
    grouped_conv1d_cf(x.detach(), w.requires_grad_(), 1, 2, 4).sum().backward()
    assert calls == ["dw"]


def test_wrappers_reject_bad_geometry_and_foreign_devices():
    x, w = torch.zeros(1, 8, 16), torch.zeros(8, 2, 5)
    with pytest.raises(ValueError, match="groups"):
        gk.grouped_conv_fwd(x, w, 1, 2, 3)
    with pytest.raises(ValueError, match="weight must be"):
        gk.grouped_conv_fwd(x, torch.zeros(8, 4, 5), 1, 2, 4)
    with pytest.raises(ValueError, match="does not belong"):
        gk.grouped_conv_dx(torch.zeros(1, 8, 9), w, 16, 1, 2, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        gk.grouped_conv_fwd(x.to("meta"), w.to("meta"), 1, 2, 4)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    dev = torch.device("cuda")
    for shape in SHAPES:
        b, wid, cin, cout, k, s, g, pad = shape
        x, w, cot = (torch.from_numpy(a).to(dev) for a in _inputs(shape, 4))
        w = w.permute(2, 1, 0).contiguous()
        for got, want in (
            (gk.grouped_conv_fwd(x, w, s, pad, g), gk.grouped_conv_fwd_plain(x, w, s, pad, g)),
            (gk.grouped_conv_dx(cot, w, wid, s, pad, g),
             gk.grouped_conv_dx_plain(cot, w, wid, s, pad, g)),
            (gk.grouped_conv_dw(x, cot, k, s, pad, g),
             gk.grouped_conv_dw_plain(x, cot, k, s, pad, g)),
        ):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        assert torch.equal(gk.grouped_conv_dw(x, cot, k, s, pad, g),
                           gk.grouped_conv_dw(x, cot, k, s, pad, g))
