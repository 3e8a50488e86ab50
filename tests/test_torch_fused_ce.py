"""The port's fused cross entropy (roar_tpu_torch/ops/fused_ce.py) against
roar_tpu/ops/fused_ce.py `fused_cross_entropy` and against the unfused form, on
the same numpy-seeded inputs: loss, accuracy and the gradients of the hidden
states, the weight and the bias.  fp32 on both sides with other summation
orders: atol 1e-5 / rtol 1e-4.  bf16 inputs: both sides widen to fp32 for the
logits tile and round dx and dW to bf16, so they agree to a bf16 step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roar_tpu.ops.fused_ce import fused_cross_entropy as jax_fused_ce
from roar_tpu_torch.ops.fused_ce import _chunk_tokens, fused_cross_entropy

TOL = dict(atol=1e-5, rtol=1e-4)
# (batch, seq, d, vocab, chunk, bias, mask): chunk dividing N, not dividing N
# (N = 60 -> 15; N = 77 -> 11), chunk above N, bias, loss mask
CASES = [
    (2, 32, 16, 50, 16, False, False), (3, 20, 16, 50, 16, False, False),
    (7, 11, 8, 33, 16, True, False), (2, 24, 16, 40, 512, True, True),
    (1, 30, 8, 20, 7, False, True),
]


def _inputs(case, seed=0):
    b, s, d, v, chunk, bias, mask = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    bvec = rng.standard_normal(v).astype(np.float32) * 0.1 if bias else None
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    m = (rng.random((b, s)) < 0.7).astype(np.float32) if mask else None
    return x, w, bvec, labels, m, chunk


def _jax_value_and_grads(x, w, bvec, labels, m, chunk, dtype=jnp.float32):
    def loss(x, w, bvec):
        return jax_fused_ce(x, w, jnp.asarray(labels), bias=bvec,
                            loss_mask=None if m is None else jnp.asarray(m), chunk=chunk)

    args = [jnp.asarray(x, dtype), jnp.asarray(w, dtype),
            None if bvec is None else jnp.asarray(bvec, dtype)]
    argnums = (0, 1) if bvec is None else (0, 1, 2)
    (value, acc), grads = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(*args)
    return float(value), float(acc), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_value_and_grads(x, w, bvec, labels, m, chunk, dtype=torch.float32, fused=True):
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(w).to(dtype).requires_grad_(True)
    tb = None if bvec is None else torch.from_numpy(bvec).to(dtype).requires_grad_(True)
    tl = torch.from_numpy(labels)
    tm = None if m is None else torch.from_numpy(m)
    if fused:
        loss, acc = fused_cross_entropy(tx, tw, tl, bias=tb, loss_mask=tm, chunk=chunk)
    else:
        logits = tx.float() @ tw.float() + (0 if tb is None else tb.float())
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, tl.long()[..., None])[..., 0]
        hit = (logits.argmax(-1) == tl).float()
        weights = torch.ones_like(nll) if tm is None else tm
        loss = (nll * weights).sum() / weights.sum().clamp(min=1.0)
        acc = (hit * weights).sum() / weights.sum().clamp(min=1.0)
    wanted = [t for t in (tx, tw, tb) if t is not None]
    grads = torch.autograd.grad(loss, wanted)
    return float(loss.detach()), float(acc), [g.float().numpy() for g in grads]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_ce_matches_jax(case):
    inputs = _inputs(case)
    loss_j, acc_j, grads_j = _jax_value_and_grads(*inputs)
    loss_t, acc_t, grads_t = _torch_value_and_grads(*inputs)
    np.testing.assert_allclose(loss_t, loss_j, **TOL)
    np.testing.assert_allclose(acc_t, acc_j, atol=1e-6)
    assert len(grads_t) == len(grads_j)
    for name, g, w in zip(("dx", "dw", "db"), grads_t, grads_j):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_ce_matches_the_unfused_form(case):
    inputs = _inputs(case, seed=1)
    loss_f, acc_f, grads_f = _torch_value_and_grads(*inputs)
    loss_u, acc_u, grads_u = _torch_value_and_grads(*inputs, fused=False)
    np.testing.assert_allclose(loss_f, loss_u, **TOL)
    assert acc_f == pytest.approx(acc_u, abs=1e-6)
    for name, g, w in zip(("dx", "dw", "db"), grads_f, grads_u):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]], ids=["plain", "bias-mask"])
def test_fused_ce_bf16_inputs_match_jax(case):
    """bf16 x, w, b.  The loss is an fp32 sum of fp32 logits on both sides;
    each gradient is rounded to bf16 once on each side, and dx's product takes
    a bf16 dlogits: one to two bf16 steps (2^-8) of the largest magnitude."""
    inputs = _inputs(case, seed=2)
    loss_j, acc_j, grads_j = _jax_value_and_grads(*inputs, dtype=jnp.bfloat16)
    loss_t, acc_t, grads_t = _torch_value_and_grads(*inputs, dtype=torch.bfloat16)
    np.testing.assert_allclose(loss_t, loss_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(acc_t, acc_j, atol=1e-6)
    for name, g, w in zip(("dx", "dw", "db"), grads_t, grads_j):
        np.testing.assert_allclose(g, w, err_msg=name, atol=2.0 ** -7 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("n,chunk,want", [(60, 16, 15), (77, 16, 11), (48, 512, 48), (13, 4, 1)])
def test_chunk_tokens_is_the_largest_divisor(n, chunk, want):
    from roar_tpu.ops.fused_ce import _chunk_tokens as jax_chunk_tokens

    assert _chunk_tokens(n, chunk) == jax_chunk_tokens(n, chunk) == want


def test_fused_ce_saves_no_logits_for_backward():
    """The autograd graph keeps x, w, targets, weights and the per-token lse:
    nothing of size [tokens, vocab]."""
    x, w, _, labels, _, _ = _inputs((2, 32, 16, 50, 16, False, False))
    tx = torch.from_numpy(x).requires_grad_(True)
    sizes = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: sizes.append(t.numel()) or t,
                                                  lambda t: t):
        fused_cross_entropy(tx, torch.from_numpy(w), torch.from_numpy(labels), chunk=16)
    assert max(sizes) < 64 * 50
