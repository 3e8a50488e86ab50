"""FastPitch without learned alignment (given durations), port against the JAX
package, on the CPU at the small size of tests/test_torch_fastpitch_train.py
(2 + 2 layers, d_model 64, 72 mel frames); and `parse` through the
ENCharParser.

`learn_alignment: false` with no `alignment_module`: the decoder is fed the
batch's `durations`, the duration loss is taken against them, the prosody
losses are scaled 1.0, and frame-level pitch and energy are averaged over the
*predicted* durations (a quirk of the JAX module, kept: ROADMAP N2).  The JAX
task's `loss_fn` passes the module no decoder length in this regime, and
`regulate_len` raises without one; the port takes the mel bucket's length.
So the JAX side here runs the JAX task's own `loss_fn` with its module's
`apply` given `max_mel_len` = the mel bucket.  Loss terms, every gradient and
3 AdamW + Noam steps at rtol 3e-3.
"""

import numpy as np
import pytest
import test_torch_fastpitch_train as fp_tests
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu_torch.models.fastpitch_model import FastPitchModel
from roar_tpu_torch.ops.lengths import average_features
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import TrainState, train_step

TOL = dict(rtol=3e-3, atol=1e-6)
T_MEL = 72
TERMS = {"mel_loss", "dur_loss", "pitch_loss", "energy_loss", "loss"}


def _cfg(dropout=0.0):
    cfg = fp_tests._cfg(dropout=dropout, dropatt=dropout)
    cfg.pop("alignment_module")
    cfg["speaker_emb_condition_aligner"] = False
    return {**cfg, "learn_alignment": False}


def _batch_np():
    """tests/test_torch_fastpitch_train.py's batch without the prior, with
    durations of at least one frame a token that sum to each mel length."""
    batch = fp_tests._batch_np()
    del batch["align_prior_matrix"]
    rng = np.random.default_rng(1)
    durs = np.zeros(batch["text"].shape, np.float32)
    for j, (n_text, n_mel) in enumerate(zip(batch["text_len"], batch["mel_len"])):
        durs[j, :n_text] = 1 + rng.multinomial(n_mel - n_text, np.full(n_text, 1.0 / n_text))
    batch["durations"] = durs
    return batch


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch_np().items()}


class _WithMelBucket:
    """A flax module whose `apply` is given the decoder length `max_mel_len`,
    which the JAX task's `loss_fn` does not pass without learned alignment."""

    def __init__(self, module, max_mel_len):
        self.module, self.max_mel_len = module, max_mel_len

    def apply(self, params, *args, **kwargs):
        return self.module.apply(params, *args, max_mel_len=self.max_mel_len, **kwargs)

    def __getattr__(self, name):
        return getattr(self.module, name)


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel
    from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
    from roar_tpu.training.trainer import create_train_state, make_train_step

    model = JaxFastPitchModel(_cfg())
    assert not model.learn_alignment and model.module.aligner is None
    assert model.dur_loss_scale == model.pitch_loss_scale == model.energy_loss_scale == 1.0
    batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    # the JAX task cannot initialise itself here either: its `init_params`
    # hands the module a spec, which it refuses without learned alignment
    with pytest.raises(ValueError, match="alignment is not learned"):
        model.init_params(jax.random.PRNGKey(0), batch)
    params = jax.device_get(model.module.init(
        {"params": jax.random.PRNGKey(0)}, batch["text"], durs=batch["durations"],
        pitch=batch["pitch"], energy=batch["energy"], speaker=batch["speaker_id"],
        max_mel_len=T_MEL))
    # a duration bias of log 4: predicted durations of about 3 frames, so that
    # the pitch and energy averages over them are not empty
    params["params"]["duration_predictor_module"]["fc"]["bias"] = np.full(1, np.log(4.0),
                                                                         np.float32)
    model.module = _WithMelBucket(model.module, T_MEL)

    def loss_fn(p, b, epoch):
        return model.loss_fn(p, b, None, epoch, deterministic=True)

    (loss, metrics), grads = jax.device_get(jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, batch, fp_tests.EPOCH), has_aux=True))(params))
    forward = jax.device_get(jax.jit(lambda p: model.module.apply(
        p, batch["text"], durs=batch["durations"], pitch=batch["pitch"],
        energy=batch["energy"], speaker=batch["speaker_id"]))(params))
    optimizer = jax_build_optimizer(fp_tests.OPTIM, gradient_clip_val=fp_tests.CLIP)
    step = make_train_step(lambda p, b, rng, epoch: loss_fn(p, b, epoch), optimizer,
                           donate=False)
    state = create_train_state(params, optimizer)
    trajectory = []
    for _ in range(fp_tests.N_STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0), fp_tests.EPOCH)
        trajectory.append({k: float(v) for k, v in m.items()})
    return {"params": params, "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "forward": forward, "trajectory": trajectory,
            "final": jax.device_get(state.params)}


def _port_model(params):
    model = FastPitchModel(_cfg())
    convert.load_fastpitch_params(model.module, params)
    return model


def test_given_durations_loss_terms_and_gradients_match_jax(jax_side):
    model = _port_model(jax_side["params"])
    assert not model.learn_alignment and model.module.aligner_module is None
    assert model.dur_loss_scale == model.pitch_loss_scale == model.energy_loss_scale == 1.0
    loss, metrics = model.loss_fn(_torch_batch(), fp_tests.EPOCH)
    assert set(metrics) == set(jax_side["metrics"]) == TERMS
    for k, want in jax_side["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, err_msg=k, **TOL)
    loss.backward()
    want = jax_side["grads"]
    scale = max(float(np.abs(v).max()) for v in convert.flatten_params(want).values())
    fp_tests._assert_tree_close(fp_tests._grad_tree(model), want, "grad", rtol=3e-3,
                                atol=3e-6 * scale)


def test_decoder_takes_the_given_durations_and_pitch_the_predicted_ones(jax_side):
    """The decoder is fed the batch's durations (its frames sum to each mel
    length); frame-level pitch and energy are averaged over the durations the
    module predicts, not the given ones, as the JAX module averages them."""
    model = _port_model(jax_side["params"])
    batch = _torch_batch()
    with torch.no_grad():
        out = model.module(batch["text"].long(), durs=batch["durations"], pitch=batch["pitch"],
                           energy=batch["energy"], speaker=batch["speaker_id"].long(),
                           max_mel_len=T_MEL)
    want = jax_side["forward"]
    np.testing.assert_array_equal(out["num_frames"].numpy(), batch["mel_len"].numpy())
    np.testing.assert_array_equal(out["num_frames"].numpy(), want["num_frames"])
    for key in ("spect", "durs_predicted", "pitch", "energy_tgt", "pitch_predicted"):
        np.testing.assert_allclose(out[key].numpy(), want[key], err_msg=key,
                                   **fp_tests.FWD_TOL)
    assert out["attn_hard"] is None and out["attn_soft"] is None
    by_predicted = average_features(batch["pitch"][:, None], out["durs_predicted"])[:, 0]
    by_given = average_features(batch["pitch"][:, None], batch["durations"])[:, 0]
    assert torch.equal(out["pitch"], by_predicted)
    assert not torch.allclose(out["pitch"], by_given)


def test_three_adamw_noam_steps_follow_the_jax_trajectory(jax_side):
    model = _port_model(jax_side["params"])
    opt = build_optimizer(model.parameters(), fp_tests.OPTIM, gradient_clip_val=fp_tests.CLIP)
    state = TrainState(model=model, opt=opt)
    batch = _torch_batch()
    for want in jax_side["trajectory"]:
        state, metrics = train_step(state, batch, fp_tests.EPOCH)
        assert set(metrics) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    assert state.step == fp_tests.N_STEPS
    fp_tests._assert_tree_close(convert.fastpitch_to_jax_tree(model.module), jax_side["final"],
                                "params", rtol=3e-3, atol=2e-4, skip_key_bias=True)


SENTENCES = ["Mr. Jones bought 2 cars.", "25% of A&B, at 7:30pm!", "Café naïve, the 2nd time",
             "$5.50 for Dr. Smith"]


def _parse_cfg(learn_alignment, **extra):
    """A narrow FastPitch config with an English character tokenizer."""
    cfg = {"learn_alignment": learn_alignment, "symbols_embedding_dim": 16, "n_mel_channels": 8,
           "input_fft": {"n_layer": 1, "n_head": 1, "d_model": 16, "d_head": 8, "d_inner": 16},
           "output_fft": {"n_layer": 1, "n_head": 1, "d_model": 16, "d_head": 8, "d_inner": 16},
           "duration_predictor": {"input_size": 16, "filter_size": 8},
           "pitch_predictor": {"input_size": 16, "filter_size": 8},
           "text_tokenizer": {"_target_": "roar_tpu.data.tokenizers.EnglishCharsTokenizer",
                              "pad_with_space": True}, **extra}
    if learn_alignment:
        cfg["alignment_module"] = {"n_text_channels": 16, "n_att_channels": 8}
    return cfg


@pytest.mark.parametrize("learn_alignment", [False, True])
def test_parse_matches_jax(learn_alignment):
    """Without learned alignment, `parse` runs an ENCharParser over the
    tokenizer's tokens (made once, kept on the instance); with it, the
    tokenizer.  The same ids as the JAX task's `parse` either way."""
    from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel

    def normalizer(text):
        return text.replace("cars", "trucks")

    for extra in ({}, {"text_normalizer": normalizer}):
        want = JaxFastPitchModel(_parse_cfg(learn_alignment, **extra))
        got = FastPitchModel(_parse_cfg(learn_alignment, **extra))
        for sentence in SENTENCES:
            ids = got.parse(sentence)
            assert ids.dtype == np.int32 and ids.shape[0] == 1
            np.testing.assert_array_equal(ids, want.parse(sentence), err_msg=sentence)
    if not learn_alignment:
        parser = got._parser
        got.parse("again")
        assert got._parser is parser
        assert parser.decode(got.parse("Mr. Jones")[0]) == "mister jones"
    else:
        assert not hasattr(got, "_parser")
