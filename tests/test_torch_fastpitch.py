"""FastPitch port against the JAX package: transformer stacks and `infer`.

Weights come from the JAX module's own tree, with every leaf redrawn from a
seeded numpy generator so that the conditional-LayerNorm projections (zero at
flax init) are exercised, and reach the port through
roar_tpu_torch.training.convert.  The JAX attention runs its einsum path (no
TPU); the port's `use_flash=True` runs the flash plain version on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from roar_tpu.models import fastpitch as jfp
from roar_tpu.models import transformer as jtr
from roar_tpu_torch.models import fastpitch as tfp
from roar_tpu_torch.models import transformer as ttr
from roar_tpu_torch.training.convert import load_fastpitch_params

COND = ("add", "layernorm")
D, D_HEAD, N_HEAD, D_INNER = 32, 16, 2, 48
# the bar of tests/test_convert.py:124 for transplanted fp32 FastPitch blocks
PARITY_TOL = dict(atol=2e-4, rtol=1e-3)


def randomize(params, seed, overrides=None):
    """Draw every leaf of a tree of arrays or shapes: kernels N(0, 1/fan_in),
    biases N(0, 0.1), LayerNorm scales and conditional-scale biases
    1 + N(0, 0.1), embeddings N(0, 1).  `overrides` maps a path suffix to a
    fixed value."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flatten_dict(params).items():
        name = "/".join(path)
        shape = tuple(leaf.shape)
        if name.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            if "/layer_norm/Dense" in name or "/norm/Dense" in name:
                v *= 0.3  # conditioning modulates, it does not dominate
        elif name.endswith("/scale") or name.endswith("Dense_0/bias") and "norm/" in name:
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape)
        for suffix, value in (overrides or {}).items():
            if name.endswith(suffix):
                v = np.full(shape, value)
        out[path] = v.astype(np.float32)
    return unflatten_dict(out)


def _masked_inputs(rng, b=2, t=23):
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    lens = np.array([t, t - 9])
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    cond = rng.standard_normal((b, 1, D)).astype(np.float32)
    return x, mask, cond


@pytest.mark.parametrize("use_flash,pre_lnorm", [(True, False), (False, False), (True, True)])
def test_transformer_layer_parity(use_flash, pre_lnorm):
    rng = np.random.default_rng(0)
    x, mask, cond = _masked_inputs(rng)
    jl = jtr.TransformerLayer(N_HEAD, D, D_HEAD, D_INNER, 3, 0.0, 0.0, pre_lnorm=pre_lnorm,
                              condition_types=COND, use_flash=True)
    params = randomize(jl.init(jax.random.PRNGKey(0), x, mask, cond), 1)
    want = np.asarray(jl.apply(params, x, mask, cond))
    tl = load_fastpitch_params(ttr.TransformerLayer(N_HEAD, D, D_HEAD, D_INNER, 3, pre_lnorm,
                                                    condition_types=COND, use_flash=use_flash),
                               params)
    with torch.no_grad():
        got = tl(*(torch.from_numpy(z) for z in (x, mask, cond))).numpy()
    np.testing.assert_allclose(got, want, **PARITY_TOL)


def test_decoder_stack_parity():
    rng = np.random.default_rng(2)
    x, mask, cond = _masked_inputs(rng, t=70)
    jd = jtr.FFTransformerDecoder(2, N_HEAD, D, D_HEAD, D_INNER, 3, 0.0, 0.0,
                                  condition_types=COND, use_flash=True)
    params = randomize(jd.init(jax.random.PRNGKey(0), x, mask, cond), 3)
    want = np.asarray(jd.apply(params, x, mask, cond)[0])
    td = load_fastpitch_params(ttr.FFTransformerDecoder(2, N_HEAD, D, D_HEAD, D_INNER, 3,
                                                        condition_types=COND, use_flash=True),
                               params)
    with torch.no_grad():
        got = td(*(torch.from_numpy(z) for z in (x, mask, cond)))[0].numpy()
    np.testing.assert_allclose(got, want, **PARITY_TOL)


def test_encoder_stack_parity():
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 30, size=(3, 19))
    tokens[1, 11:] = 0  # padding_idx 0
    tokens[2, 1:] = 0
    cond = rng.standard_normal((3, 1, D)).astype(np.float32)
    je = jtr.FFTransformerEncoder(2, N_HEAD, D, D_HEAD, D_INNER, 3, 0.0, 0.0, n_embed=30,
                                  condition_types=COND, use_flash=True)
    params = randomize(je.init(jax.random.PRNGKey(0), jnp.asarray(tokens), cond), 5)
    out, mask = je.apply(params, jnp.asarray(tokens), cond)
    te = load_fastpitch_params(ttr.FFTransformerEncoder(2, N_HEAD, D, D_HEAD, D_INNER, 3,
                                                        n_embed=30, condition_types=COND,
                                                        use_flash=True), params)
    with torch.no_grad():
        got, got_mask = te(torch.from_numpy(tokens), torch.from_numpy(cond))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **PARITY_TOL)


def _fastpitch_pair(energy: bool):
    fft = jfp.FFTConfig(n_layer=2, n_head=N_HEAD, d_model=D, d_head=D_HEAD, d_inner=D_INNER,
                        condition_types=COND, use_flash=True)
    pred = jfp.PredictorConfig(input_size=D, filter_size=16, condition_types=COND)
    common = dict(n_symbols=40, n_speakers=3, symbols_embedding_dim=D, n_mel_channels=20,
                  min_token_duration=1, max_token_duration=20,
                  speaker_emb_condition_prosody=True, speaker_emb_condition_decoder=True)
    jm = jfp.FastPitchModule(
        encoder=fft, decoder=fft, duration_predictor=pred, pitch_predictor=pred,
        energy_predictor=pred if energy else None,
        aligner=jfp.AlignerConfig(n_text_channels=D, n_att_channels=16), **common)
    tfft = tfp.FFTConfig(n_layer=2, n_head=N_HEAD, d_model=D, d_head=D_HEAD, d_inner=D_INNER,
                         condition_types=COND, use_flash=True)
    tpred = tfp.PredictorConfig(input_size=D, filter_size=16, condition_types=COND)
    tm = tfp.FastPitchModule(encoder=tfft, decoder=tfft, duration_predictor=tpred,
                             pitch_predictor=tpred, energy_predictor=tpred if energy else None,
                             **common)
    return jm, tm


@pytest.mark.parametrize("energy", [False, True])
def test_fastpitch_infer_parity(energy):
    rng = np.random.default_rng(6)
    b, t_text, t_mel, cap = 3, 17, 40, 384
    text = rng.integers(1, 40, size=(b, t_text))
    text[1, 12:] = 0
    text[2, 5:] = 0
    speaker = np.array([0, 2, 1])
    jm, tm = _fastpitch_pair(energy)
    # the training forward creates every leaf, the aligner's included: the
    # converter must skip those
    params = jax.eval_shape(lambda key: jm.init(
        {"params": key}, jnp.asarray(text), speaker=jnp.asarray(speaker),
        pitch=jnp.zeros((b, t_mel)), energy=jnp.zeros((b, t_mel)),
        spec=jnp.zeros((b, t_mel, 20)), attn_prior=jnp.ones((b, t_mel, t_text)) / t_text,
        mel_lens=jnp.full((b,), t_mel), input_lens=jnp.asarray((text != 0).sum(1))),
        jax.random.PRNGKey(0))
    assert "aligner_module" in params["params"]
    # durations of about 3 frames, so the decoder sees real lengths
    params = randomize(params, 7, {"duration_predictor_module/fc/bias": np.log(4.0)})
    want = jax.jit(lambda p: jm.apply(p, jnp.asarray(text), speaker=jnp.asarray(speaker),
                                      pace=1.1, max_mel_len=cap, method=jm.infer))(params)
    load_fastpitch_params(tm, params).eval()
    with torch.no_grad():
        got = tm.infer(torch.from_numpy(text), speaker=torch.from_numpy(speaker), pace=1.1,
                       max_mel_len=cap)
    np.testing.assert_array_equal(got["num_frames"].numpy(), np.asarray(want["num_frames"]))
    assert 0 < int(got["num_frames"].min()) and int(got["num_frames"].max()) < cap
    for key in ("log_durs_predicted", "pitch_predicted", "spect"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **PARITY_TOL,
                                   err_msg=key)


def test_regulate_len_matches_jax():
    from roar_tpu.ops.lengths import regulate_len as jax_regulate
    from roar_tpu_torch.ops.lengths import regulate_len

    rng = np.random.default_rng(8)
    durs = rng.uniform(0, 4, size=(3, 9)).astype(np.float32)
    durs[0, 2] = 0.0
    durs[1, :] = [0.5, 1.5, 2.5, 0.49, 3.5, 0.0, 1.0, 2.0, 75.0]  # rounding edges, clamp
    enc = rng.standard_normal((3, 9, 5)).astype(np.float32)
    for pace, max_len in ((1.0, 40), (1.3, 40), (0.7, 12)):
        want_rep, want_lens = jax_regulate(jnp.asarray(durs), jnp.asarray(enc), pace, max_len)
        got_rep, got_lens = regulate_len(torch.from_numpy(durs), torch.from_numpy(enc), pace,
                                         max_len)
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        np.testing.assert_array_equal(got_rep.numpy(), np.asarray(want_rep))


@pytest.mark.parametrize("types", [("add",), ("concat",), ("add", "concat")])
def test_conditional_input_parity(types):
    from roar_tpu.models.submodules import ConditionalInput as JaxConditionalInput
    from roar_tpu_torch.models.submodules import ConditionalInput

    rng = np.random.default_rng(9)
    x, _, cond = _masked_inputs(rng, t=7)
    jmod = JaxConditionalInput(D, D, types)
    params = randomize(jmod.init(jax.random.PRNGKey(0), x, cond), 10)
    want = np.asarray(jmod.apply(params, x, cond))
    tmod = load_fastpitch_params(ConditionalInput(D, D, types), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, **PARITY_TOL)
