"""Monotonic alignment search of the port against the JAX package: the hard
alignment must be EQUAL, not close.  Every operation of the DP is an add, a
max or a comparison of float32, so both packages take the same path, ties
included (`take_m1 >= take`, roar_tpu/ops/mas.py:91).  Shape classes of
tests/test_mas.py, plus forced ties and length-1 edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roar_tpu.ops.mas import binarize_attention as jax_binarize
from roar_tpu.ops.mas import mas_width1 as jax_mas
from roar_tpu_torch.ops.mas import binarize_attention, mas_width1


def _both(log_attn, text_lens, mel_lens):
    want = np.asarray(jax_mas(jnp.asarray(log_attn), jnp.asarray(text_lens),
                              jnp.asarray(mel_lens)))
    got = mas_width1(torch.from_numpy(log_attn), torch.from_numpy(text_lens),
                     torch.from_numpy(mel_lens))
    assert got.dtype == torch.float32 and not got.requires_grad
    return got.numpy(), want


def _check_is_a_monotonic_path(hard, text_lens, mel_lens):
    for b in range(hard.shape[0]):
        rect = hard[b, : mel_lens[b], : text_lens[b]]
        assert hard[b].sum() == rect.sum() == mel_lens[b]  # zero outside the rectangle
        cols = rect.argmax(1)
        assert (rect.sum(1) == 1).all() and cols[0] == 0 and cols[-1] == text_lens[b] - 1
        assert set(np.diff(cols)) <= {0, 1}


@pytest.mark.parametrize("trial", range(5))
def test_random_single_utterance(trial):
    rng = np.random.default_rng(trial)
    t_mel, t_text = 40 + trial * 7, 12 + trial
    la = np.log(rng.random((1, t_mel, t_text)).astype(np.float32) + 1e-3)
    got, want = _both(la, np.array([t_text], np.int32), np.array([t_mel], np.int32))
    np.testing.assert_array_equal(got, want)
    _check_is_a_monotonic_path(got, [t_text], [t_mel])


def test_batched_variable_lengths():
    rng = np.random.default_rng(1)
    la = np.log(rng.random((4, 64, 20)).astype(np.float32) + 1e-3)
    mel_lens = np.array([64, 50, 33, 61], np.int32)
    text_lens = np.array([20, 11, 7, 19], np.int32)
    got, want = _both(la, text_lens, mel_lens)
    np.testing.assert_array_equal(got, want)
    _check_is_a_monotonic_path(got, text_lens, mel_lens)


@pytest.mark.parametrize("kind", ["constant", "integers", "two_levels", "repeated_rows"])
def test_forced_ties_take_the_same_branch(kind):
    rng = np.random.default_rng(2)
    b, t_mel, t_text = 3, 48, 15
    if kind == "constant":
        la = np.zeros((b, t_mel, t_text), np.float32)
    elif kind == "integers":
        la = -rng.integers(0, 3, (b, t_mel, t_text)).astype(np.float32)
    elif kind == "two_levels":
        la = np.where(rng.random((b, t_mel, t_text)) < 0.5, -1.0, -2.0).astype(np.float32)
    else:
        la = np.repeat(np.log(rng.random((b, 1, t_text)).astype(np.float32) + 1e-3), t_mel, 1)
    mel_lens = np.array([48, 31, 15], np.int32)
    text_lens = np.array([15, 15, 15], np.int32)  # the last: as many frames as tokens
    got, want = _both(la, text_lens, mel_lens)
    np.testing.assert_array_equal(got, want)
    _check_is_a_monotonic_path(got, text_lens, mel_lens)


@pytest.mark.parametrize("t_mel,t_text,mel_len,text_len", [
    (1, 1, 1, 1), (9, 1, 9, 1), (9, 6, 1, 1), (2, 2, 2, 2), (12, 5, 7, 1), (12, 5, 5, 5),
])
def test_length_one_edges(t_mel, t_text, mel_len, text_len):
    rng = np.random.default_rng(3)
    la = np.log(rng.random((2, t_mel, t_text)).astype(np.float32) + 1e-3)
    mel_lens = np.array([mel_len, t_mel], np.int32)
    text_lens = np.array([text_len, min(t_text, t_mel)], np.int32)
    got, want = _both(la, text_lens, mel_lens)
    np.testing.assert_array_equal(got, want)
    _check_is_a_monotonic_path(got, text_lens, mel_lens)


def test_prefers_the_diagonal():
    t = 8
    la = np.full((1, t, t), -10.0, np.float32)
    la[0, np.arange(t), np.arange(t)] = 0.0
    got, want = _both(la, np.array([t], np.int32), np.array([t], np.int32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.eye(t, dtype=np.float32))


@pytest.mark.parametrize("four_d", [True, False])
def test_binarize_attention_matches_jax(four_d):
    """From probabilities: the log is taken on each side, on values where
    torch's and XLA's float32 log agree (powers of two and their neighbours
    would be as good; here a softmax of seeded logits)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 50, 14)).astype(np.float32) * 3.0
    soft = np.exp(logits - logits.max(-1, keepdims=True))
    soft = (soft / soft.sum(-1, keepdims=True)).astype(np.float32)
    soft[0, :, 10:] = 0.0  # below eps: clipped to 1e-12 on both sides
    mel_lens, text_lens = np.array([50, 37, 20], np.int32), np.array([10, 14, 9], np.int32)
    a = soft[:, None] if four_d else soft
    want = np.asarray(jax_binarize(jnp.asarray(a), jnp.asarray(text_lens), jnp.asarray(mel_lens)))
    x = torch.from_numpy(a).requires_grad_(True)
    got = binarize_attention(x, torch.from_numpy(text_lens), torch.from_numpy(mel_lens))
    assert not got.requires_grad and got.shape == a.shape
    np.testing.assert_array_equal(got.numpy(), want)
