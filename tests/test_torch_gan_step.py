"""The HiFi-GAN task and its D+G step, port against the JAX package.

`HifiGanModel` at the widths of tests/test_gan_training.py: the D and G
losses with their parts, the gradients of both, then three full D+G steps
against `HifiGanModel.make_train_step(shared_forward=True)` with the same
AdamW + CosineAnnealing.  Weights start from the JAX init and are carried
across by training/convert.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from roar_tpu.models.hifigan_model import HifiGanModel as JaxHifiGanModel
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu_torch.models.hifigan_model import HifiGanModel
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.gan import GANTrainState, gan_train_step
from roar_tpu_torch.training.optim import build_optimizer

# the bar for losses and gradients between the two frameworks in fp32: other
# summation orders through a generator, eight discriminators and two mels
TOL = dict(rtol=3e-3, atol=1e-5)
N_STEPS = 3
OPTIM = {"name": "adamw", "lr": 2e-4, "betas": [0.8, 0.99],
         "sched": {"name": "CosineAnnealing", "min_lr": 1e-5, "warmup_steps": 2}}
MAX_STEPS = 10

CFG = {
    "preprocessor": {
        "sample_rate": 22050, "nfilt": 32, "n_window_size": 512, "n_window_stride": 128,
        "n_fft": 512, "lowfreq": 0, "highfreq": 8000, "pad_to": 0, "pad_value": -11.52,
        "normalize": None, "preemph": None, "dither": 0.0, "log": True,
        "log_zero_guard_type": "clamp", "log_zero_guard_value": 1e-05, "mag_power": 1.0,
        "exact_pad": True,
    },
    "generator": {
        "resblock": 2, "upsample_rates": [8, 4, 4], "upsample_kernel_sizes": [16, 8, 8],
        "upsample_initial_channel": 48, "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1, 3]],
    },
    "l1_loss_factor": 45,
    "debug": True,
}


def _batch_np():
    rng = np.random.default_rng(0)
    seg = 2048
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(2 * seg).reshape(2, seg) / 22050)
             + 0.01 * rng.standard_normal((2, seg))).astype(np.float32)
    return {"audio": audio, "audio_len": np.array([seg, seg], np.int32)}


def _port_model(g_params, d_params, d_stats):
    model = HifiGanModel(CFG)
    convert.load_gan_bundle(model.generator, model.mpd, model.msd, jax.device_get(
        {"g_params": g_params, "d_params": d_params, "d_stats": d_stats}))
    return model


def _port_tree(model):
    return convert.to_jax_tree(model.generator, model.mpd, model.msd)


def _assert_tree_close(got, want, what, **tol):
    got_flat, want_flat = flatten_dict(got), flatten_dict(jax.device_get(want))
    assert set(got_flat) == set(want_flat)
    for path, value in want_flat.items():
        np.testing.assert_allclose(got_flat[path], np.asarray(value), err_msg=f"{what} {path}",
                                   **tol)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX task, its initial state, the losses and gradients on the
    initial state and the trajectory of N_STEPS jitted steps."""
    model = JaxHifiGanModel(CFG)
    batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    g_opt = jax_build_optimizer(OPTIM, max_steps=MAX_STEPS)
    d_opt = jax_build_optimizer(OPTIM, max_steps=MAX_STEPS)
    state = model.init_state(jax.random.PRNGKey(0), batch, g_opt, d_opt)
    init = jax.device_get((state.g_params, state.d_params, state.d_stats))

    @jax.jit
    def losses_and_grads(g_params, d_params, d_stats):
        diff_out, f_vjp, aux = jax.vjp(lambda gp: model.forward_split(gp, batch, None, 0),
                                       g_params, has_aux=True)
        sg = jax.lax.stop_gradient(diff_out)
        (d_loss, (d_metrics, new_stats)), d_grads = jax.value_and_grad(
            lambda dp: model.d_loss_from_out(dp, d_stats, sg, aux, batch), has_aux=True)(d_params)
        # the G loss through the same (not yet updated) discriminators
        (g_loss, g_metrics), out_bar = jax.value_and_grad(
            lambda do: model.g_loss_from_out(do, aux, d_params, new_stats, batch, 0),
            has_aux=True)(diff_out)
        (g_grads,) = f_vjp(out_bar)
        return d_loss, d_metrics, d_grads, new_stats, g_loss, g_metrics, g_grads

    first = jax.device_get(losses_and_grads(*init))
    step = model.make_train_step(g_opt, d_opt, shared_forward=True)
    rng = jax.random.PRNGKey(1)
    trajectory = []
    for _ in range(N_STEPS):
        rng, sub = jax.random.split(rng)
        state, metrics = step(state, batch, sub, 0)
        trajectory.append({k: float(v) for k, v in metrics.items()})
    final = jax.device_get((state.g_params, state.d_params, state.d_stats))
    return {"init": init, "first": first, "trajectory": trajectory, "final": final}


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch_np().items()}


def test_mel_configs_match_the_jax_task():
    jm, pm = JaxHifiGanModel(CFG), HifiGanModel(CFG)
    assert pm.mel_cfg.use_grads and pm.trg_mel_cfg.highfreq is None
    for field in ("sample_rate", "n_window_size", "n_window_stride", "n_fft", "nfilt", "lowfreq",
                  "highfreq", "log_zero_guard_type", "log_zero_guard_value", "mag_power",
                  "exact_pad", "pad_value", "pad_to", "use_grads", "normalize", "preemph"):
        assert getattr(pm.mel_cfg, field) == getattr(jm.mel_cfg, field), field
        if field != "highfreq":
            assert getattr(pm.trg_mel_cfg, field) == getattr(jm.trg_mel_cfg, field), field
    assert pm.generator.upsample_factor == pm.mel_cfg.hop_length
    assert pm.l1_factor == jm.l1_factor == 45


def test_d_loss_parts_gradients_and_stats(jax_side):
    d_loss, d_metrics, d_grads, new_stats, *_ = jax_side["first"]
    model = _port_model(*jax_side["init"])
    batch = _torch_batch()
    fake = model.forward_split(batch)["fake"].detach()
    loss, metrics = model.d_loss_from_out({"fake": fake}, batch)
    np.testing.assert_allclose(float(loss.detach()), float(d_loss), **TOL)
    for k, v in d_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), err_msg=k, **TOL)
    loss.backward()
    grads = HifiGanModel(CFG)
    with torch.no_grad():
        for dst, src in ((grads.mpd, model.mpd), (grads.msd, model.msd)):
            dst.load_state_dict(src.state_dict())
            for p_dst, p_src in zip(dst.parameters(), src.parameters()):
                p_dst.copy_(p_src.grad)
    got = _port_tree(grads)
    _assert_tree_close(got["d_params"], d_grads, "d grad", rtol=3e-3, atol=1e-6)
    _assert_tree_close(_port_tree(model)["d_stats"], new_stats, "stats", rtol=1e-4, atol=1e-6)


def test_g_loss_parts_and_gradients(jax_side):
    *_, new_stats, g_loss, g_metrics, g_grads = jax_side["first"]
    g_params, d_params, _ = jax_side["init"]
    model = _port_model(g_params, d_params, new_stats)
    batch = _torch_batch()
    for p in model.d_parameters():
        p.requires_grad_(False)
    loss, metrics = model.g_loss_from_out(model.forward_split(batch), batch)
    np.testing.assert_allclose(float(loss.detach()), float(g_loss), **TOL)
    assert set(metrics) == {"g_mel_loss", "g_fm_loss", "g_adv_loss"}
    for k, v in g_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), err_msg=k, **TOL)
    loss.backward()
    assert all(p.grad is None for p in model.d_parameters())
    with torch.no_grad():
        for p in model.generator.parameters():
            p.copy_(p.grad)
    scale = max(float(np.abs(v).max()) for v in flatten_dict(g_grads).values())
    _assert_tree_close(convert.generator_to_jax_tree(model.generator), g_grads, "g grad",
                       rtol=3e-3, atol=1e-5 * scale)


def test_three_steps_follow_the_jax_trajectory(jax_side):
    model = _port_model(*jax_side["init"])
    state = GANTrainState(
        model=model,
        g_opt=build_optimizer(model.g_parameters(), OPTIM, max_steps=MAX_STEPS),
        d_opt=build_optimizer(model.d_parameters(), OPTIM, max_steps=MAX_STEPS))
    batch = _torch_batch()
    for want in jax_side["trajectory"]:
        state, metrics = gan_train_step(state, batch)
        assert set(metrics) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    assert state.step == N_STEPS and state.g_opt.count == N_STEPS
    got = _port_tree(model)
    g_final, d_final, stats_final = jax_side["final"]
    # AdamW moves every weight by about lr per step whatever its gradient's
    # size, so after 3 steps two runs may differ by a fraction of 3 * lr
    # where a gradient is at rounding level: atol 2e-5 beside the 3e-3 bar
    _assert_tree_close(got["g_params"], g_final, "g", rtol=3e-3, atol=2e-5)
    _assert_tree_close(got["d_params"], d_final, "d", rtol=3e-3, atol=2e-5)
    _assert_tree_close(got["d_stats"], stats_final, "stats", rtol=3e-3, atol=2e-5)
    assert all(p.requires_grad for p in model.d_parameters())


def test_precomputed_mel_in_the_batch_wins_and_unported_parts_raise():
    model = HifiGanModel(CFG, generator=torch.Generator().manual_seed(0))
    batch = _torch_batch()
    mel = torch.zeros(2, 4, 32)
    assert model._input_mel({**batch, "mel": mel}) is mel
    assert model._input_mel(batch).shape == (2, 2048 // 128, 32)
    assert model.convert_spectrogram_to_audio(mel).shape == (2, 4 * 128)
    # ported (tests/test_torch_griffin_lim.py holds them to JAX): the bias
    # spectrum of the generator, and denoise at strength 0 is the STFT round trip
    bias = model.compute_stft_bias()
    assert bias.shape == (1, 512 // 2 + 1, 1) and torch.isfinite(bias).all()
    audio = 0.1 * torch.randn(1, 4096, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(model.denoise(audio, strength=0.0, stft_bias=bias)[:, 512:3584],
                               audio[:, 512:3584], rtol=0, atol=1e-5)
