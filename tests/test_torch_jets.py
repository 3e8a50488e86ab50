"""JETS, port against the JAX package, on the CPU at the small size of
tests/test_jets.py (d 32, 1 + 1 FFT layers, debug discriminators, segment 8
frames, batch 2), as it is and conditioned as configs/jets_22050_align.yaml
conditions it: an energy predictor, three speakers, and the speaker embedding
added to the encoder, predictors, aligner and decoder.

The same numpy batch goes through `roar_tpu`'s `JETSModel` and the port's
`JETSModel`, the weights carried across by training/convert.py: the module
forward and `infer` at dropout 0, the D and G losses with every gradient, and
three shared-forward GAN steps with AdamW and the cosine schedule, for both
multi-scale discriminator variants.  The JAX grouped MSD takes XLA's grouped
conv on the CPU, the port the plain versions of the grouped-conv kernels.
The JAX run's segment starts come from flax's rng streams, which torch cannot
follow: the port takes them through `ops.lengths.draw_segment_starts`, the
one place where it draws them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_jets import jets_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu.models.jets_model import JETSModel as JaxJETSModel
from roar_tpu.ops.priors import beta_binomial_prior_np
from roar_tpu.training.gan import create_gan_state
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu_torch.models.jets_model import JETSModel
from roar_tpu_torch.ops import lengths
from roar_tpu_torch.training import convert, run
from roar_tpu_torch.training.gan import GANTrainState, gan_train_step
from roar_tpu_torch.training.optim import build_optimizer

# module outputs: fp32 on both sides, other summation orders (the bar of
# tests/test_torch_fastpitch.py); losses, gradients and steps: the bar of
# tests/test_torch_gan_step.py
FWD_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = dict(rtol=3e-3, atol=1e-5)
EPOCH = 1  # half of jets_cfg's bin_loss_warmup_epochs: the bin term carries weight 0.5
STEP_EPOCHS = (0, 1, 2)  # the bin weight goes 0, 0.5, 1 over the three steps
OPTIM = {"name": "adamw", "lr": 2e-4, "betas": [0.8, 0.99],
         "sched": {"name": "CosineAnnealing", "min_lr": 1e-5, "warmup_steps": 2}}
MAX_STEPS = 10
FLAVOURS = ["plain", "conditioned"]
# (flavour, MSD variant) of the loss, gradient and step comparisons
SIDES = [("plain", "grouped"), ("plain", "dense"), ("conditioned", "grouped")]
N_SPEAKERS = 3
SPEAKERS = [2, 0]


def _cfg(variant="grouped", dropout=0.0, flavour="plain"):
    cfg = jets_cfg()
    if flavour == "conditioned":
        d = cfg["symbols_embedding_dim"]
        both = ["add", "layernorm"]
        cfg.update(energy_predictor={"input_size": d, "filter_size": 16},
                   speaker_encoder={"lookup_module": {"n_speakers": N_SPEAKERS,
                                                      "embedding_dim": d}},
                   speaker_emb_condition_prosody=True, speaker_emb_condition_decoder=True,
                   speaker_emb_condition_aligner=True)
        for k in ("input_fft", "output_fft", "duration_predictor", "pitch_predictor",
                  "energy_predictor"):
            cfg[k] = {**cfg[k], "condition_types": both}
        cfg["alignment_module"] = {**cfg["alignment_module"], "condition_types": ["add"]}
    for k in ("input_fft", "output_fft"):
        cfg[k] = {**cfg[k], "dropout": dropout, "dropatt": dropout}
    for k in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        if k in cfg:
            cfg[k] = {**cfg[k], "dropout": dropout}
    cfg["msd_variant"] = variant
    return cfg


def _batch_np(flavour="plain"):
    """tests/test_jets.py's batch: 8192 and 7168 samples (64 and 56 frames at
    hop 128), texts of 10 and 8 tokens; conditioned, also energy per frame
    and a speaker per row."""
    rng = np.random.default_rng(0)
    b, t_text, sr, n = 2, 10, 22050, 8192
    t_mel = n // 128
    audio = (0.3 * np.sin(2 * np.pi * 180 * np.arange(b * n).reshape(b, n) / sr)
             + 0.01 * rng.standard_normal((b, n))).astype(np.float32)
    batch = {
        "audio": audio, "audio_len": np.array([n, n - 1024], np.int32),
        "text": rng.integers(1, 40, size=(b, t_text)).astype(np.int32),
        "text_len": np.array([t_text, t_text - 2], np.int32),
        "pitch": rng.standard_normal((b, t_mel)).astype(np.float32),
        "align_prior_matrix": np.broadcast_to(beta_binomial_prior_np(t_text, t_mel),
                                              (b, t_mel, t_text)).copy(),
    }
    if flavour == "conditioned":
        batch["energy"] = rng.uniform(0.0, 5.0, (b, t_mel)).astype(np.float32)
        batch["speaker_id"] = np.array(SPEAKERS, np.int32)
    return batch


def _torch_batch(flavour="plain"):
    return {k: torch.from_numpy(v) for k, v in _batch_np(flavour).items()}


def _starts(monkeypatch, *starts):
    """The port's next draws of segment starts are `starts`, in turn."""
    queue = [torch.tensor(np.asarray(s), dtype=torch.int32) for s in starts]
    monkeypatch.setattr(lengths, "draw_segment_starts", lambda *args: queue.pop(0))


def _port_model(tree, variant="grouped", flavour="plain"):
    model = JETSModel(_cfg(variant, flavour=flavour))
    convert.load_jets_bundle(model.module, model.mpd, model.msd, jax.device_get(tree))
    return model


def _assert_tree_close(got, want, what, skip_key_bias=False, **tol):
    got_flat, want_flat = flatten_dict(got), flatten_dict(jax.device_get(want))
    assert set(got_flat) == set(want_flat)
    for path, value in want_flat.items():
        g, w = got_flat[path], np.asarray(value)
        if skip_key_bias and path[-2:] == ("qkv_net", "bias"):
            third = w.shape[0] // 3
            g, w = np.delete(g, np.s_[third:2 * third]), np.delete(w, np.s_[third:2 * third])
        np.testing.assert_allclose(g, w, err_msg=f"{what} {'/'.join(path)}", **tol)


def _grads_as_tree(model):
    """The gradients held in `model`'s parameters as the JAX bundle tree."""
    grads = JETSModel(model.cfg)
    with torch.no_grad():
        for dst, src in zip(grads.state_modules().values(), model.state_modules().values()):
            dst.load_state_dict(src.state_dict())
            for p_dst, p_src in zip(dst.parameters(), src.parameters()):
                p_dst.copy_(p_src.grad if p_src.grad is not None else torch.zeros_like(p_src))
    return grads.to_jax_tree()


@functools.lru_cache(maxsize=None)
def _jax_init(flavour):
    """The JAX task and its initial parameters; the duration predictor's
    bias set to log 4 so that `infer` gives every token 3 frames."""
    model = JaxJETSModel(_cfg(flavour=flavour))
    batch = {k: jnp.asarray(v) for k, v in _batch_np(flavour).items()}
    g, d, stats = jax.device_get(model.init_params(jax.random.PRNGKey(0), batch))
    g["params"]["duration_predictor_module"]["fc"]["bias"] = np.full(1, np.log(4.0), np.float32)
    return model, batch, {"g_params": g, "d_params": d, "d_stats": stats}


@pytest.fixture(scope="module", params=FLAVOURS)
def jax_init(request):
    return (request.param, *_jax_init(request.param))


@pytest.fixture(scope="module", params=SIDES, ids=["-".join(side) for side in SIDES])
def jax_side(request):
    """Per flavour and MSD variant: the losses and gradients on the initial
    state, and the trajectory of three jitted shared-forward steps."""
    flavour, variant = request.param
    _, batch, tree = _jax_init(flavour)
    model = JaxJETSModel(_cfg(variant, flavour=flavour))
    init = dict(tree)
    if variant != "grouped":
        _, d_params, d_stats = jax.device_get(model.init_params(jax.random.PRNGKey(0), batch))
        init.update(d_params=d_params, d_stats=d_stats)

    @jax.jit
    def losses_and_grads(g_params, d_params, d_stats, rng):
        diff_out, f_vjp, aux = jax.vjp(lambda gp: model.forward_split(gp, batch, rng, EPOCH),
                                       g_params, has_aux=True)
        sg = jax.lax.stop_gradient(diff_out)
        (d_loss, (d_metrics, new_stats)), d_grads = jax.value_and_grad(
            lambda dp: model.d_loss_from_out(dp, d_stats, sg, aux, batch), has_aux=True)(d_params)
        # the G loss through the same (not yet updated) discriminators
        (g_loss, g_metrics), out_bar = jax.value_and_grad(
            lambda do: model.g_loss_from_out(do, aux, d_params, new_stats, batch, EPOCH),
            has_aux=True)(diff_out)
        (g_grads,) = f_vjp(out_bar)
        return (d_loss, d_metrics, d_grads, new_stats, g_loss, g_metrics, g_grads,
                aux["z_start_idxs"])

    first = jax.device_get(losses_and_grads(init["g_params"], init["d_params"],
                                            init["d_stats"], jax.random.PRNGKey(5)))
    starts = jax.jit(lambda g, r: model.forward_split(g, batch, r, 0)[1]["z_start_idxs"])
    g_opt = jax_build_optimizer(OPTIM, max_steps=MAX_STEPS)
    d_opt = jax_build_optimizer(OPTIM, max_steps=MAX_STEPS)
    state = create_gan_state(init["g_params"], init["d_params"], g_opt, d_opt, init["d_stats"])
    step = model.make_train_step(g_opt, d_opt, shared_forward=True)
    rng = jax.random.PRNGKey(1)
    trajectory, step_starts = [], []
    for epoch in STEP_EPOCHS:
        rng, sub = jax.random.split(rng)
        step_starts.append(np.asarray(starts(init["g_params"], sub)))
        state, metrics = step(state, batch, sub, epoch)
        trajectory.append({k: float(v) for k, v in metrics.items()})
    final = jax.device_get({"g_params": state.g_params, "d_params": state.d_params,
                            "d_stats": state.d_stats})
    return {"flavour": flavour, "variant": variant, "init": init, "first": first,
            "trajectory": trajectory, "starts": step_starts, "final": final}


def test_parameter_tree_round_trips_and_unconsumed_leaves_raise(jax_init):
    flavour, _, _, tree = jax_init
    model = _port_model(tree, flavour=flavour)
    got = model.to_jax_tree()
    got_flat, want_flat = flatten_dict(got), flatten_dict(tree)
    assert set(got_flat) == set(want_flat)
    for key, value in want_flat.items():
        np.testing.assert_array_equal(got_flat[key], np.asarray(value), err_msg=str(key))
    assert "generator" in tree["g_params"]["params"]  # the flax scope of the vocoder

    g = tree["g_params"]
    extra = {"params": {**g["params"], "pitch_emb": {**g["params"]["pitch_emb"],
                                                    "stray": np.zeros(1, np.float32)}}}
    with pytest.raises(ValueError, match="not consumed"):
        convert.load_jets_params(JETSModel(_cfg(flavour=flavour)).module, extra)
    short = {"params": {k: v for k, v in g["params"].items() if k != "pitch_emb"}}
    with pytest.raises(KeyError, match="unfilled"):
        convert.load_jets_params(JETSModel(_cfg(flavour=flavour)).module, short)
    gen = {"params": {**g["params"], "generator": {**g["params"]["generator"],
                                                  "Conv_9": {"bias": np.zeros(1)}}}}
    with pytest.raises(ValueError, match="not consumed"):
        convert.load_jets_params(JETSModel(_cfg(flavour=flavour)).module, gen)
    if flavour == "conditioned":
        assert {"energy_emb", "speaker_table"} <= set(g["params"])


EXACT = ("attn_hard", "attn_hard_dur", "num_frames", "mel_lens", "z_start_idxs")


def test_module_forward_matches_jax(jax_init, monkeypatch):
    flavour, model, batch, tree = jax_init
    want = jax.device_get(jax.jit(lambda g: model._forward(g, batch, jax.random.PRNGKey(2),
                                                           deterministic=True))(tree["g_params"]))
    port = _port_model(tree, flavour=flavour)
    _starts(monkeypatch, want["z_start_idxs"])
    with torch.no_grad():
        got = port._forward(_torch_batch(flavour), deterministic=True)
    assert {k for k, v in want.items() if v is not None} == set(got)
    for k in EXACT:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    close = {"wav", "attn_soft", "attn_logprob", "log_durs_predicted", "durs_predicted",
             "pitch_predicted", "pitch"}
    if flavour == "conditioned":
        close |= {"energy_pred", "energy_tgt"}
    assert close == set(got) - set(EXACT)
    for k in sorted(close):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **FWD_TOL)
    assert got["wav"].shape == (2, 8 * 128)
    np.testing.assert_array_equal(got["attn_hard_dur"].sum(-1).numpy(), got["mel_lens"].numpy())


def test_infer_matches_jax(jax_init):
    flavour, model, batch, tree = jax_init
    speaker = batch.get("speaker_id")
    want = jax.device_get(jax.jit(lambda g: model.module.apply(
        g, batch["text"], speaker=speaker, max_mel_len=64,
        method=model.module.infer))(tree["g_params"]))
    port = _port_model(tree, flavour=flavour)
    text = _torch_batch(flavour)["text"].long()
    speaker = None if speaker is None else torch.tensor(SPEAKERS)
    out = port.module.eval().infer(text, speaker=speaker, max_mel_len=64)
    np.testing.assert_array_equal(out["num_frames"].numpy(), np.asarray(want["num_frames"]))
    assert int(out["num_frames"].min()) > 0  # the bias of log 4 gives the tokens frames
    for k in ("wav", "durs_predicted", "log_durs_predicted"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **FWD_TOL)
    wav, frames = port.convert_text_to_waveform(text, speaker, max_mel_len=64)
    assert wav.shape == (2, 64 * 128) and torch.equal(frames, out["num_frames"])


def test_d_and_g_losses_and_gradients_match_jax(jax_side, monkeypatch):
    d_loss, d_metrics, d_grads, new_stats, g_loss, g_metrics, g_grads, starts = jax_side["first"]
    flavour, variant, init = jax_side["flavour"], jax_side["variant"], jax_side["init"]
    batch = _torch_batch(flavour)

    model = _port_model(init, variant, flavour)
    _starts(monkeypatch, starts)
    out = model.forward_split(batch, EPOCH)
    np.testing.assert_array_equal(out["z_start_idxs"].numpy(), starts)
    loss, metrics = model.d_loss_from_out({k: v.detach() for k, v in out.items()}, batch)
    np.testing.assert_allclose(float(loss.detach()), float(d_loss), **TOL)
    assert set(metrics) == set(d_metrics)
    for k, v in d_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), err_msg=k, **TOL)
    loss.backward()
    got = _grads_as_tree(model)
    _assert_tree_close(got["d_params"], d_grads, "d grad", rtol=3e-3, atol=1e-6)
    _assert_tree_close(model.to_jax_tree()["d_stats"], new_stats, "stats", rtol=1e-4, atol=1e-6)

    model = _port_model({**init, "d_stats": new_stats}, variant, flavour)
    for p in model.d_parameters():
        p.requires_grad_(False)
    _starts(monkeypatch, starts)
    loss, metrics = model.g_loss_from_out(model.forward_split(batch, EPOCH), batch, EPOCH)
    np.testing.assert_allclose(float(loss.detach()), float(g_loss), **TOL)
    terms = {"g_mel_loss", "dur_loss", "pitch_loss", "ctc_loss", "bin_loss", "g_fm_loss",
             "g_adv_loss"}
    assert set(metrics) == set(g_metrics) == terms | (
        {"energy_loss"} if flavour == "conditioned" else set())
    assert float(metrics["bin_loss"].detach()) > 0.0
    for k, v in g_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), err_msg=k, **TOL)
    loss.backward()
    assert all(p.grad is None for p in model.d_parameters())
    scale = max(float(np.abs(v).max()) for v in flatten_dict(g_grads).values())
    _assert_tree_close(_grads_as_tree(model)["g_params"], g_grads, "g grad",
                       rtol=3e-3, atol=1e-5 * scale)


def test_three_steps_follow_the_jax_trajectory(jax_side, monkeypatch):
    model = _port_model(jax_side["init"], jax_side["variant"], jax_side["flavour"])
    state = GANTrainState(
        model=model,
        g_opt=build_optimizer(model.g_parameters(), OPTIM, max_steps=MAX_STEPS),
        d_opt=build_optimizer(model.d_parameters(), OPTIM, max_steps=MAX_STEPS))
    batch = _torch_batch(jax_side["flavour"])
    _starts(monkeypatch, *jax_side["starts"])
    bin_losses = []
    for epoch, want in zip(STEP_EPOCHS, jax_side["trajectory"]):
        state, metrics = gan_train_step(state, batch, epoch=epoch)
        assert set(metrics) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
        bin_losses.append(float(metrics["bin_loss"]))
    assert bin_losses[0] == 0.0 and 0.0 < bin_losses[1] < bin_losses[2]
    assert state.step == len(STEP_EPOCHS) and state.g_opt.count == len(STEP_EPOCHS)
    # AdamW moves every weight by about lr per step whatever its gradient's
    # size: atol 2e-5 beside the 3e-3 bar, as tests/test_torch_gan_step.py.
    # The key third of each qkv bias has a gradient of zero in exact
    # arithmetic (softmax ignores a shift of every key's score), so both
    # sides step it by +-lr on the sign of rounding noise: left out, as
    # tests/test_torch_fastpitch_train.py does
    _assert_tree_close(model.to_jax_tree(), jax_side["final"], "after 3 steps",
                       skip_key_bias=True, rtol=3e-3, atol=2e-5)


def test_same_seed_same_segment_starts_and_dropout():
    batch = _torch_batch()
    outs = []
    for _ in range(2):
        model = JETSModel(_cfg(dropout=0.1), generator=torch.Generator().manual_seed(0))
        model.set_dropout_generator(torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs.append([model.forward_split(batch) for _ in range(2)])
    for a, b in zip(*outs):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for out in outs[0]:
        z = out["z_start_idxs"]
        assert ((0 <= z) & (z <= out["mel_lens"] - 8)).all()
    # dropout acts: a training forward differs from the deterministic one
    assert not torch.equal(outs[0][0]["log_durs_predicted"],
                           model._forward(batch, deterministic=True)["log_durs_predicted"])


def test_unported_options_raise_by_name():
    # JETS takes bf16 (set_compute_dtype); a GAN task without it raises by name

    class TaskWithoutComputeDtype:
        pass

    with pytest.raises(NotImplementedError, match="bf16.*TaskWithoutComputeDtype"):
        run.train_gan({"trainer": {"precision": "bf16-mixed"}, "model": {}},
                      TaskWithoutComputeDtype(), None, device="cpu")
    # a Conformer stack builds (tests/test_torch_conformer.py holds it to JAX);
    # an adapter on a transformer stack builds too (tests/test_torch_finetune.py)
    cfg = _cfg()
    cfg["input_fft"] = {**cfg["input_fft"], "encoder_type": "conformer"}
    assert type(JETSModel(cfg).module.encoder_module).__name__ == "FFConformerEncoder"
    adapted = JETSModel({**_cfg(), "output_fft": {**_cfg()["output_fft"], "adapter_dim": 8}})
    assert all(layer.adapter is not None for layer in adapted.module.decoder_module.layers)
    # use_gst is ignored, as the JAX task ignores it (tests/test_torch_gst.py)
    assert getattr(JETSModel({**_cfg(), "use_gst": True}).module, "gst_module", None) is None
    with pytest.raises(ValueError, match="upsample"):
        JETSModel({**_cfg(), "waveform_generator": {**_cfg()["waveform_generator"],
                                                    "upsample_rates": [8, 4, 2]}})
