"""`AlignmentEncoder` of the port against the JAX package on the CPU: the soft
attention and its log-probs for both distance types, with and without the
beta-binomial prior, with and without speaker conditioning, and the gradients
of every parameter.  Weights start from the flax init and are carried across
by training/convert.py (the flax scopes `key_proj_0/Conv_0`, ... are read from
the tree the JAX module really makes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roar_tpu.models.aligner import AlignmentEncoder as JaxAlignmentEncoder
from roar_tpu_torch.models.aligner import AlignmentEncoder
from roar_tpu_torch.models.submodules import ConvNorm
from roar_tpu_torch.ops.priors import beta_binomial_prior_np
from roar_tpu_torch.training import convert

# fp32 on both sides; the distance is a sum of three terms of size |q|^2, so
# its rounding is relative to them, not to the (smaller) result
TOL = dict(atol=2e-5, rtol=1e-4)
B, T_MEL, T_TEXT, N_MEL, N_TEXT, N_ATT = 2, 45, 13, 20, 32, 16


def _inputs():
    rng = np.random.default_rng(0)
    queries = rng.standard_normal((B, T_MEL, N_MEL)).astype(np.float32)
    keys = rng.standard_normal((B, T_TEXT, N_TEXT)).astype(np.float32)
    text_lens, mel_lens = np.array([13, 8]), np.array([45, 30])
    key_mask = np.arange(T_TEXT)[None, :] < text_lens[:, None]
    prior = np.zeros((B, T_MEL, T_TEXT), np.float32)
    for j in range(B):
        prior[j, : mel_lens[j], : text_lens[j]] = beta_binomial_prior_np(
            int(text_lens[j]), int(mel_lens[j]))
    cond = rng.standard_normal((B, 1, N_TEXT)).astype(np.float32)
    return queries, keys, key_mask, prior, cond, text_lens, mel_lens


@pytest.mark.parametrize("dist_type,use_prior,conditioned", [
    ("l2", True, True), ("l2", False, False), ("l2", True, False),
    ("cosine", True, True), ("cosine", False, False),
])
def test_alignment_encoder_matches_jax(dist_type, use_prior, conditioned):
    queries, keys, key_mask, prior, cond, _, _ = _inputs()
    kwargs = dict(n_mel_channels=N_MEL, n_text_channels=N_TEXT, n_att_channels=N_ATT,
                  temperature=0.05, dist_type=dist_type,
                  condition_types=("add",) if conditioned else ())
    jmod = JaxAlignmentEncoder(**kwargs)
    call = dict(key_mask=jnp.asarray(key_mask),
                attn_prior=jnp.asarray(prior) if use_prior else None,
                conditioning=jnp.asarray(cond) if conditioned else None)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(queries), jnp.asarray(keys), **call)
    want_soft, want_logprob = jmod.apply(params, jnp.asarray(queries), jnp.asarray(keys), **call)

    tmod = convert.load_fastpitch_params(AlignmentEncoder(**kwargs), jax.device_get(params))
    got_soft, got_logprob = tmod(
        torch.from_numpy(queries), torch.from_numpy(keys), key_mask=torch.from_numpy(key_mask),
        attn_prior=torch.from_numpy(prior) if use_prior else None,
        conditioning=torch.from_numpy(cond) if conditioned else None)
    assert got_soft.shape == got_logprob.shape == (B, 1, T_MEL, T_TEXT)
    np.testing.assert_allclose(got_soft.detach().numpy(), np.asarray(want_soft), **TOL)
    np.testing.assert_allclose(got_logprob.detach().numpy(), np.asarray(want_logprob),
                               atol=2e-4, rtol=1e-4)
    # masked text columns carry no probability
    assert float(got_soft.detach()[1, 0, :, 8:].abs().max()) == 0.0

    # gradients of a weighted sum of both outputs, for every parameter
    w = np.random.default_rng(1).standard_normal((B, 1, T_MEL, T_TEXT)).astype(np.float32)
    w_lp = w * key_mask[:, None, None, :] * (prior[:, None] > 0 if use_prior else 1.0)

    def loss(p):
        soft, logprob = jmod.apply(p, jnp.asarray(queries), jnp.asarray(keys), **call)
        return jnp.sum(soft * w) + 0.01 * jnp.sum(jnp.where(w_lp != 0, logprob, 0.0) * w_lp)

    want_grads = convert.flatten_params(jax.device_get(jax.grad(loss)(params)))
    lp = torch.where(torch.from_numpy(w_lp != 0), got_logprob, 0.0) * torch.from_numpy(w_lp)
    ((got_soft * torch.from_numpy(w)).sum() + 0.01 * lp.sum()).backward()
    grads = AlignmentEncoder(**kwargs)
    with torch.no_grad():
        for dst, src in zip(grads.parameters(), tmod.parameters()):
            dst.copy_(src.grad)
    got_grads = convert.flatten_params(convert.fastpitch_to_jax_tree(grads))
    assert set(got_grads) == set(want_grads)
    scale = max(float(np.abs(v).max()) for v in want_grads.values())
    for name, want in want_grads.items():
        np.testing.assert_allclose(got_grads[name], want, err_msg=name, rtol=3e-3,
                                   atol=1e-5 * scale)


def test_get_durations_sums_to_the_mel_lengths():
    from roar_tpu.models.aligner import AlignmentEncoder as J

    _, _, _, prior, _, text_lens, mel_lens = _inputs()
    soft = prior / np.maximum(prior.sum(-1, keepdims=True), 1e-9)
    want = np.asarray(J.get_durations(jnp.asarray(soft[:, None]), jnp.asarray(text_lens),
                                      jnp.asarray(mel_lens)))
    got = AlignmentEncoder.get_durations(torch.from_numpy(soft[:, None]),
                                         torch.from_numpy(text_lens),
                                         torch.from_numpy(mel_lens)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(1), mel_lens)


def test_conv_norm_matches_jax_and_unknown_distance_raises():
    from roar_tpu.models.submodules import ConvNorm as JaxConvNorm

    x = np.random.default_rng(2).standard_normal((2, 11, 6)).astype(np.float32)
    jmod = JaxConvNorm(10, kernel_size=3, w_init_gain="relu")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tmod = convert.load_fastpitch_params(ConvNorm(6, 10, kernel_size=3, w_init_gain="relu"),
                                         jax.device_get(params))
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmod.apply(params, jnp.asarray(x))), **TOL)
    with pytest.raises(ValueError, match="Unknown distance"):
        AlignmentEncoder(dist_type="l1")
