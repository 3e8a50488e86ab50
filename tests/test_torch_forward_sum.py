"""Forward-sum and binarization losses of the port against the JAX package.

The JAX package evaluates the monotonic CTC lattice with its own alpha
recursion (`lax.scan`); the port calls `F.ctc_loss(zero_infinity=True)` on the
same blank-padded, masked, log-softmaxed matrix.  Loss and gradient agree at
rtol 3e-3 (fp32 log-sum-exp chains of up to 60 frames in two orders), an
infeasible utterance contributes exactly 0 on both sides.  Cases of
tests/test_forward_sum.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roar_tpu.ops.forward_sum import bin_loss as jax_bin_loss
from roar_tpu.ops.forward_sum import forward_sum_loss as jax_forward_sum_loss
from roar_tpu_torch.ops.forward_sum import bin_loss, forward_sum_loss

TOL = dict(rtol=3e-3, atol=1e-6)


def _compare(attn_logprob, text_lens, mel_lens, **kwargs):
    tl, ml = jnp.asarray(text_lens), jnp.asarray(mel_lens)
    want, want_grad = jax.value_and_grad(
        lambda x: jax_forward_sum_loss(x, tl, ml, **kwargs))(jnp.asarray(attn_logprob))
    x = torch.from_numpy(attn_logprob).requires_grad_(True)
    got = forward_sum_loss(x, torch.from_numpy(text_lens), torch.from_numpy(mel_lens), **kwargs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=3e-3,
                               atol=1e-5 * float(np.abs(want_grad).max()))
    return float(got.detach()), x.grad.numpy()


@pytest.mark.parametrize("four_d", [True, False])
def test_uniform_lengths(four_d):
    rng = np.random.default_rng(0)
    b, t_mel, t_text = 3, 30, 8
    x = rng.standard_normal((b, 1, t_mel, t_text)).astype(np.float32)
    x = x if four_d else x[:, 0]
    loss, _ = _compare(x, np.full((b,), t_text, np.int32), np.full((b,), t_mel, np.int32))
    assert np.isfinite(loss) and loss > 0


@pytest.mark.parametrize("seed", [1, 2])
def test_ragged_lengths(seed):
    rng = np.random.default_rng(seed)
    b, t_mel, t_text = 4, 60, 12
    x = rng.standard_normal((b, 1, t_mel, t_text)).astype(np.float32) * 2.0
    text_lens = np.array([12, 7, 3, 1], np.int32)
    mel_lens = np.array([60, 41, 17, 5], np.int32)
    _, grad = _compare(x, text_lens, mel_lens)
    assert np.isfinite(grad).all()
    # nothing flows to frames past mel_len or tokens past text_len
    assert np.abs(grad[1, 0, 41:]).max() == 0.0 and np.abs(grad[2, 0, :, 3:]).max() == 0.0


def test_blank_logprob_and_loss_scale():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 25, 6)).astype(np.float32)
    lens = (np.array([6, 4], np.int32), np.array([25, 20], np.int32))
    a, _ = _compare(x, *lens, blank_logprob=-3.0, loss_scale=0.5)
    b, _ = _compare(x, *lens)
    assert a != pytest.approx(0.5 * b, rel=1e-3)  # the blank's weight matters


def test_infeasible_utterance_contributes_zero():
    """Text longer than its mel frames: no monotonic path exists; torch's
    zero_infinity and the JAX package both give that row 0 loss and 0 gradient."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, 20, 10)).astype(np.float32)
    text_lens = np.array([10, 9, 4], np.int32)
    mel_lens = np.array([20, 5, 12], np.int32)  # row 1: 9 tokens in 5 frames
    loss, grad = _compare(x, text_lens, mel_lens)
    assert np.isfinite(loss) and np.abs(grad[1]).max() == 0.0
    feasible = [0, 2]
    only, _ = _compare(x[feasible], text_lens[feasible], mel_lens[feasible])
    np.testing.assert_allclose(loss * 3, only * 2, rtol=1e-5)


def test_bin_loss_matches_jax_and_its_formula():
    rng = np.random.default_rng(5)
    soft = rng.random((2, 1, 12, 5)).astype(np.float32)
    soft[0, 0, 0, 0] = 0.0  # clipped at 1e-12
    hard = np.zeros_like(soft)
    hard[:, 0, np.arange(12), np.minimum(np.arange(12) // 3, 4)] = 1.0
    want, want_grad = jax.value_and_grad(
        lambda s: jax_bin_loss(jnp.asarray(hard), s, loss_scale=0.7))(jnp.asarray(soft))
    x = torch.from_numpy(soft).requires_grad_(True)
    got = bin_loss(torch.from_numpy(hard), x, loss_scale=0.7)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)
    ref = -0.7 * np.log(np.clip(soft[hard == 1], 1e-12, None)).sum() / hard.sum()
    np.testing.assert_allclose(float(got.detach()), ref, rtol=1e-5)
    assert float(bin_loss(torch.zeros(1, 1, 3, 2), torch.ones(1, 1, 3, 2))) == 0.0
