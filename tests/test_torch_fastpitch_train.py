"""The FastPitch training step with learned alignment, port against the JAX
package, on the CPU at a small size (2 + 2 layers, d_model 64, 72 mel frames).

The same numpy batch goes through `roar_tpu`'s `FastPitchModel.loss_fn`
(`deterministic=True`) and the port's (`eval()` mode, or every dropout rate 0
in training mode), with the weights carried across by training/convert.py.
Off the TPU the JAX `MultiHeadAttn(use_flash=True)` takes its einsum path; the
port takes the autograd Function with the kernels' plain versions.  Dropout
cannot follow JAX's random stream, so it is tested on its own.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu.training.trainer import create_train_state, make_train_step
from roar_tpu_torch.models.fastpitch_model import FastPitchModel, spec_from_batch
from roar_tpu_torch.models.submodules import Dropout
from roar_tpu_torch.ops.priors import beta_binomial_prior_np
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import Trainer, TrainState, train_step

# module outputs: fp32 on both sides, other summation orders (the bar of
# tests/test_torch_fastpitch.py); losses, gradients and steps: the bar the JAX
# package held against its own reference
FWD_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = dict(rtol=3e-3, atol=1e-6)
EPOCH = 50  # half of bin_loss_warmup_epochs: the bin term carries weight 0.5
N_STEPS = 3
OPTIM = {"name": "adamw", "lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 1e-6,
         "sched": {"name": "NoamAnnealing", "warmup_steps": 2, "last_epoch": -1, "d_model": 1}}
CLIP = 1000.0


def _cfg(dropout=0.1, dropatt=0.1, use_flash=True):
    cond = ["add", "layernorm"]
    fft = {"n_layer": 2, "n_head": 2, "d_model": 64, "d_head": 32, "d_inner": 96,
           "kernel_size": 3, "dropout": dropout, "dropatt": dropatt, "dropemb": 0.0,
           "condition_types": cond, "use_flash": use_flash}
    predictor = {"input_size": 64, "kernel_size": 3, "filter_size": 32, "dropout": dropout,
                 "n_layers": 2, "condition_types": cond}
    return {
        "learn_alignment": True, "bin_loss_warmup_epochs": 100, "n_symbols": 40,
        "max_token_duration": 75, "symbols_embedding_dim": 64, "n_mel_channels": 16,
        "pitch_embedding_kernel_size": 3, "energy_embedding_kernel_size": 3,
        "preprocessor": {"sample_rate": 22050, "features": 16, "n_window_size": 512,
                         "n_window_stride": 128, "n_fft": 512, "lowfreq": 0, "highfreq": 8000,
                         "pad_to": 1, "pad_value": 0, "normalize": None, "preemph": None,
                         "dither": 0.0, "log": True, "log_zero_guard_type": "add",
                         "log_zero_guard_value": 1e-05, "mag_power": 1.0},
        "input_fft": {**fft, "d_embed": 64}, "output_fft": dict(fft),
        "alignment_module": {"n_text_channels": 64, "n_att_channels": 24,
                             "condition_types": ["add"]},
        "duration_predictor": dict(predictor), "pitch_predictor": dict(predictor),
        "energy_predictor": dict(predictor),
        "speaker_encoder": {"lookup_module": {"n_speakers": 3, "embedding_dim": 64}},
        "speaker_emb_condition_prosody": True, "speaker_emb_condition_decoder": True,
        "speaker_emb_condition_aligner": True,
    }


def _batch_np():
    """Two utterances: audio of 8192 and 5000 samples (65 and 40 mel frames)
    collated into a mel bucket of 72, texts of 16 and 9 tokens."""
    rng = np.random.default_rng(0)
    t_mel, t_text = 72, 16
    audio_len = np.array([8192, 5000], np.int32)
    audio = 0.1 * rng.standard_normal((2, 8192)).astype(np.float32)
    audio[1, 5000:] = 0.0
    mel_len = audio_len // 128 + 1
    text_len = np.array([16, 9], np.int32)
    text = rng.integers(1, 40, (2, t_text)).astype(np.int32)
    text[1, 9:] = 0
    pitch = rng.standard_normal((2, t_mel)).astype(np.float32)
    pitch[rng.random((2, t_mel)) < 0.3] = 0.0  # unvoiced frames
    energy = np.abs(rng.standard_normal((2, t_mel))).astype(np.float32)
    prior = np.zeros((2, t_mel, t_text), np.float32)
    for j in range(2):
        pitch[j, mel_len[j]:] = 0.0
        energy[j, mel_len[j]:] = 0.0
        prior[j, : mel_len[j], : text_len[j]] = beta_binomial_prior_np(
            int(text_len[j]), int(mel_len[j]))
    return {"audio": audio, "audio_len": audio_len, "text": text, "text_len": text_len,
            "mel_len": mel_len.astype(np.int32), "pitch": pitch, "energy": energy,
            "align_prior_matrix": prior, "speaker_id": np.array([2, 0], np.int32)}


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch_np().items()}


def _port_model(params, **cfg_kwargs):
    model = FastPitchModel(_cfg(**cfg_kwargs))
    convert.load_fastpitch_params(model.module, jax.device_get(params))
    return model


def _assert_tree_close(got, want, what, rtol, atol, skip_key_bias=False):
    got_flat, want_flat = flatten_dict(got), flatten_dict(jax.device_get(want))
    assert set(got_flat) == set(want_flat)
    for path, value in want_flat.items():
        g, w = got_flat[path], np.asarray(value)
        if skip_key_bias and path[-2:] == ("qkv_net", "bias"):
            third = w.shape[0] // 3
            g, w = np.delete(g, np.s_[third:2 * third]), np.delete(w, np.s_[third:2 * third])
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")


def _grad_tree(model):
    grads = copy.deepcopy(model.module)
    with torch.no_grad():
        for dst, src in zip(grads.parameters(), model.module.parameters()):
            dst.copy_(src.grad)
    return convert.fastpitch_to_jax_tree(grads)


@pytest.fixture(scope="module")
def jax_side():
    model = JaxFastPitchModel(_cfg())
    batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    params = model.init_params(jax.random.PRNGKey(0), batch)

    @jax.jit
    def forward(params):
        spec, mel_lens = model._spec_from_batch(batch["audio"], batch["audio_len"], batch)
        out = model.module.apply(
            params, batch["text"], pitch=batch["pitch"], energy=batch["energy"],
            speaker=batch["speaker_id"], spec=spec, attn_prior=batch["align_prior_matrix"],
            mel_lens=mel_lens, input_lens=batch["text_len"], deterministic=True)
        return spec, mel_lens, out

    @jax.jit
    def loss_and_grads(params):
        return jax.value_and_grad(
            lambda p: model.loss_fn(p, batch, None, EPOCH, deterministic=True),
            has_aux=True)(params)

    optimizer = jax_build_optimizer(OPTIM, gradient_clip_val=CLIP)
    step = make_train_step(
        lambda p, b, rng, epoch: model.loss_fn(p, b, None, epoch, deterministic=True),
        optimizer, donate=False)
    state = create_train_state(params, optimizer)
    trajectory = []
    for _ in range(N_STEPS):
        state, metrics = step(state, batch, jax.random.PRNGKey(0), EPOCH)
        trajectory.append({k: float(v) for k, v in metrics.items()})
    (loss, metrics), grads = loss_and_grads(params)
    return {"params": jax.device_get(params), "forward": jax.device_get(forward(params)),
            "loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.device_get(grads), "trajectory": trajectory,
            "final": jax.device_get(state.params)}


def test_parameter_tree_round_trip(jax_side):
    """Every flax leaf is consumed, every port parameter filled, and
    `fastpitch_to_jax_tree` gives the same tree back bit for bit."""
    model = _port_model(jax_side["params"])
    _assert_tree_close(convert.fastpitch_to_jax_tree(model.module), jax_side["params"],
                       "round trip", rtol=0.0, atol=0.0)
    flat = convert.flatten_params(jax_side["params"])
    assert "aligner_module/key_proj_0/Conv_0/kernel" in flat
    assert "aligner_module/query_proj_2/Conv_0/bias" in flat
    broken = {k: v for k, v in flat.items() if k != "aligner_module/query_proj_2/Conv_0/bias"}
    with pytest.raises(KeyError, match="unfilled"):
        convert.load_fastpitch_params(FastPitchModel(_cfg()).module,
                                      convert._nest({tuple(k.split("/")): v
                                                     for k, v in broken.items()}))


def test_module_forward_matches_jax(jax_side):
    spec_w, mel_lens_w, out_w = jax_side["forward"]
    model = _port_model(jax_side["params"])
    assert not model.module.training
    batch = _torch_batch()
    spec, mel_lens = spec_from_batch(batch, model.mel_cfg)
    np.testing.assert_array_equal(mel_lens.numpy(), mel_lens_w)
    np.testing.assert_allclose(spec.numpy(), spec_w, **FWD_TOL)
    # the loss masks the mel by `target != 0`: the zeros must be the same zeros
    np.testing.assert_array_equal(spec.numpy() == 0.0, spec_w == 0.0)
    with torch.no_grad():
        out = model.module(batch["text"].long(), pitch=batch["pitch"], energy=batch["energy"],
                           speaker=batch["speaker_id"].long(), spec=spec,
                           attn_prior=batch["align_prior_matrix"], mel_lens=mel_lens,
                           input_lens=batch["text_len"])
    assert set(out) == set(out_w)
    np.testing.assert_array_equal(out["attn_hard"].numpy(), out_w["attn_hard"])
    np.testing.assert_array_equal(out["attn_hard_dur"].numpy(), out_w["attn_hard_dur"])
    np.testing.assert_array_equal(out["attn_hard_dur"].sum(1).numpy(), mel_lens_w)
    np.testing.assert_array_equal(out["num_frames"].numpy(), out_w["num_frames"])
    for key in ("spect", "durs_predicted", "log_durs_predicted", "pitch_predicted", "attn_soft",
                "attn_logprob", "pitch", "energy_pred", "energy_tgt"):
        np.testing.assert_allclose(out[key].numpy(), out_w[key], err_msg=key, **FWD_TOL)


def test_loss_terms_and_gradients_match_jax(jax_side):
    model = _port_model(jax_side["params"])
    loss, metrics = model.loss_fn(_torch_batch(), EPOCH)
    assert set(metrics) == set(jax_side["metrics"]) == {
        "mel_loss", "dur_loss", "pitch_loss", "energy_loss", "ctc_loss", "bin_loss", "loss"}
    for k, want in jax_side["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, err_msg=k, **TOL)
    assert float(metrics["bin_loss"]) > 0.0
    loss.backward()
    want = jax_side["grads"]
    scale = max(float(np.abs(v).max()) for v in flatten_dict(want).values())
    # a gradient tensor's small entries carry the rounding of its large ones
    _assert_tree_close(_grad_tree(model), want, "grad", rtol=3e-3, atol=3e-6 * scale)


def test_bin_loss_weight_is_zero_at_epoch_zero(jax_side):
    model = _port_model(jax_side["params"])
    _, metrics = model.loss_fn(_torch_batch(), 0)
    assert float(metrics["bin_loss"]) == 0.0 and float(metrics["ctc_loss"]) > 0.0


def test_three_adamw_noam_steps_follow_the_jax_trajectory(jax_side):
    """Training mode with every dropout rate 0 (the JAX side runs
    `deterministic=True`): metrics per step, `grad_norm` included, and the
    parameters after three updates."""
    model = _port_model(jax_side["params"], dropout=0.0, dropatt=0.0)
    opt = build_optimizer(model.parameters(), OPTIM, gradient_clip_val=CLIP)
    state = TrainState(model=model, opt=opt)
    batch = _torch_batch()
    for want in jax_side["trajectory"]:
        state, metrics = train_step(state, batch, EPOCH)
        assert set(metrics) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    assert state.step == N_STEPS and opt.count == N_STEPS and model.module.training
    # AdamW moves a weight by about lr per step whatever its gradient's size.
    # The key bias of an attention layer has no gradient but rounding (softmax
    # does not see a constant added to every score of a row), so its updates
    # are +-lr by the sign of noise and are left out; elsewhere atol 2e-4
    # covers gradients near rounding level over 3 steps of lr <= 7e-4
    _assert_tree_close(convert.fastpitch_to_jax_tree(model.module), jax_side["final"], "params",
                       rtol=3e-3, atol=2e-4, skip_key_bias=True)


def test_gradient_accumulation_averages_micro_batches(jax_side):
    """Two equal micro-batches with accumulate_grad_batches=2 make one update
    with the gradient of one batch: the same parameters as one plain step."""
    batch = _torch_batch()
    one = _port_model(jax_side["params"], dropout=0.0, dropatt=0.0)
    state = TrainState(model=one, opt=build_optimizer(one.parameters(), OPTIM))
    train_step(state, batch, EPOCH)
    two = _port_model(jax_side["params"], dropout=0.0, dropatt=0.0)
    state2 = TrainState(model=two, opt=build_optimizer(two.parameters(), OPTIM))
    train_step(state2, batch, EPOCH, accumulate_grad_batches=2)
    assert state2.opt.count == 0
    train_step(state2, batch, EPOCH, accumulate_grad_batches=2)
    assert state2.step == 2 and state2.opt.count == 1
    for a, b in zip(one.parameters(), two.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_dropout_is_seeded_scaled_and_off_in_eval():
    drop = Dropout(0.25)
    x = torch.ones(64, 64)
    drop.generator = torch.Generator().manual_seed(3)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(a, drop(x))
    kept = a != 0
    assert torch.equal(a[kept], torch.full_like(a[kept], 1.0 / 0.75))
    assert 0.70 < kept.float().mean() < 0.80
    assert drop.eval()(x) is x and Dropout(0.0).train()(x) is x


def test_training_mode_dropout_follows_the_generator(jax_side):
    model = _port_model(jax_side["params"])
    batch = _torch_batch()
    model.module.train()
    losses = []
    for seed in (0, 0, 1):
        model.set_dropout_generator(torch.Generator().manual_seed(seed))
        losses.append(float(model.loss_fn(batch, EPOCH)[1]["loss"]))
    assert losses[0] == losses[1] != losses[2]
    model.module.eval()
    assert float(model.loss_fn(batch, EPOCH)[1]["loss"]) == pytest.approx(jax_side["loss"],
                                                                        rel=3e-3)


def test_flash_with_active_dropatt_takes_the_einsum_path():
    """roar_tpu/models/transformer.py:165-166: flash cannot drop attention
    probabilities, so `use_flash` with `dropatt > 0` runs the einsum path in
    training mode and the flash path in eval mode."""
    from roar_tpu_torch.kernels import flash_attention as fa

    with_drop = FastPitchModel(_cfg(dropatt=0.1), generator=torch.Generator().manual_seed(0))
    no_drop = FastPitchModel(_cfg(dropatt=0.0), generator=torch.Generator().manual_seed(0))
    assert with_drop.attention_paths() == {"input_fft": "flash", "output_fft": "flash"}
    with_drop.module.train()
    no_drop.module.train()
    assert with_drop.attention_paths() == {"input_fft": "einsum", "output_fft": "einsum"}
    assert no_drop.attention_paths() == {"input_fft": "flash", "output_fft": "flash"}
    calls = []
    real = fa.flash_self_attention

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    fa.flash_self_attention = counting
    try:
        with_drop.loss_fn(_torch_batch(), 0)
        assert not calls
        no_drop.loss_fn(_torch_batch(), 0)
        assert len(calls) == 4  # 2 encoder + 2 decoder layers
    finally:
        fa.flash_self_attention = real


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="remat"):
        FastPitchModel({**_cfg(), "input_fft": {**_cfg()["input_fft"], "remat": True}})
    with pytest.raises(NotImplementedError, match="adapters"):
        FastPitchModel({**_cfg(), "output_fft": {**_cfg()["output_fft"], "adapter_dim": 8}})
    with pytest.raises(NotImplementedError, match="GST"):
        FastPitchModel({**_cfg(), "use_gst": True})
    model = FastPitchModel(_cfg())
    opt = build_optimizer(model.parameters(), OPTIM)
    # FastPitch takes bf16 (set_compute_dtype); a task without it raises by name
    assert Trainer(model, opt, device="cpu", precision="bf16").compute_dtype == torch.bfloat16

    class TaskWithoutComputeDtype:
        pass

    with pytest.raises(NotImplementedError, match="bf16.*TaskWithoutComputeDtype"):
        Trainer(TaskWithoutComputeDtype(), opt, device="cpu", precision="bf16")
    with pytest.raises(NotImplementedError, match="freeze_updates"):
        Trainer(model, opt, device="cpu", freeze_updates={"enabled": True, "modules": {}})
    with pytest.raises(NotImplementedError, match="mesh"):
        Trainer(model, opt, device="cpu", mesh=object())


def test_interpolate_speaker_blends_two_rows(jax_side):
    jmodel = JaxFastPitchModel(_cfg())
    want = jmodel.interpolate_speaker(jax_side["params"], 0, 2, 0.25, 0.75, 1)
    model = _port_model(jax_side["params"])
    model.interpolate_speaker(0, 2, 0.25, 0.75, 1)
    np.testing.assert_allclose(model.module.speaker_table.weight.detach().numpy(),
                               np.asarray(want["params"]["speaker_table"]["embedding"]),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="out of range"):
        model.interpolate_speaker(0, 5, 0.5, 0.5, 1)
