"""The port's inverse STFT and Griffin-Lim against roar_tpu/ops/griffin_lim.py,
and `HifiGanModel.compute_stft_bias` / `denoise` against the JAX pair, on
the CPU.  Griffin-Lim's starting phase is JAX's own
(`jax.random.uniform(PRNGKey(0), ...)`), handed to the port; every signal is
held at atol 1e-4 of its peak."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roar_tpu.models.hifigan_model import HifiGanModel as JaxHifiGanModel
from roar_tpu.ops import griffin_lim as jgl
from roar_tpu_torch.models.hifigan_model import HifiGanModel
from roar_tpu_torch.ops import griffin_lim as gl
from roar_tpu_torch.ops.spectrogram import stft_magnitude
from roar_tpu_torch.training import convert

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_gan_step import CFG  # noqa: E402

PEAK_ATOL = 1e-4  # of the signal's peak


def _close(got, want, what=""):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=PEAK_ATOL * np.abs(want).max(),
                               err_msg=what)


def _jax_phase(shape):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape, minval=-np.pi,
                                         maxval=np.pi))


@pytest.mark.parametrize("n_fft,hop,win,length", [(512, 128, 512, None), (512, 128, 400, None),
                                                  (1024, 256, 1024, 5000),
                                                  (512, 128, 512, 100000)])
def test_istft_matches_jax(n_fft, hop, win, length):
    rng = np.random.default_rng(n_fft + win)
    re, im = (rng.standard_normal((2, n_fft // 2 + 1, 21)).astype(np.float32) for _ in range(2))
    want = jgl.istft(jnp.asarray(re), jnp.asarray(im), n_fft, hop, win, length=length)
    got = gl.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop, win, length=length)
    _close(got.numpy(), want)


def test_griffin_lim_with_the_jax_phase_matches_jax():
    rng = np.random.default_rng(3)
    mag = np.abs(rng.standard_normal((2, 257, 30))).astype(np.float32)
    want = jgl.griffin_lim(jnp.asarray(mag), n_iters=30, n_fft=512, hop_length=128)
    got = gl.griffin_lim(torch.from_numpy(mag), n_iters=30, n_fft=512, hop_length=128,
                         phase=torch.tensor(_jax_phase(mag.shape)))
    _close(got.numpy(), want)


def test_mel_to_audio_griffin_lim_matches_jax():
    rng = np.random.default_rng(4)
    log_mel = (rng.standard_normal((1, 32, 24)) - 4.0).astype(np.float32)
    kwargs = dict(sample_rate=22050, n_fft=512, hop_length=128, win_length=512, n_mels=32,
                  fmin=0.0, fmax=8000.0, n_iters=20)
    want = jgl.mel_to_audio_griffin_lim(jnp.asarray(log_mel), **kwargs)
    got = gl.mel_to_audio_griffin_lim(torch.from_numpy(log_mel),
                                      phase=torch.tensor(_jax_phase((1, 257, 24))), **kwargs)
    _close(got.numpy(), want)


def test_default_phase_is_seeded_and_uniform():
    a, b = gl.default_phase((2, 33, 50)), gl.default_phase((2, 33, 50))
    assert torch.equal(a, b)
    assert -np.pi <= float(a.min()) and float(a.max()) < np.pi and abs(float(a.mean())) < 0.1
    mag = torch.rand(1, 257, 12, generator=torch.Generator().manual_seed(1))
    assert torch.equal(gl.griffin_lim(mag, n_iters=3, n_fft=512),
                       gl.griffin_lim(mag, n_iters=3, n_fft=512, phase=gl.default_phase(mag.shape)))


def test_griffin_lim_recovers_tone():
    sr, n_fft, hop = 22050, 512, 128
    t = np.arange(4096) / sr
    x = torch.from_numpy((0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[None])
    mag = stft_magnitude(x, n_fft, hop, n_fft, "hann", center=True)
    audio = gl.griffin_lim(mag, n_iters=30, n_fft=n_fft, hop_length=hop).numpy()
    spec = np.abs(np.fft.rfft(audio[0, 512:3584]))
    peak_hz = spec.argmax() * sr / len(audio[0, 512:3584])
    assert abs(peak_hz - 440) < 15


@pytest.fixture(scope="module")
def hifigan_pair():
    jax_model = JaxHifiGanModel(CFG)
    audio = (0.1 * np.random.default_rng(0).standard_normal((1, 4096))).astype(np.float32)
    batch = {"audio": jnp.asarray(audio), "audio_len": jnp.asarray([4096])}
    g_params, d_params, d_stats = jax_model.init_params(jax.random.PRNGKey(0), batch)
    model = HifiGanModel(CFG)
    convert.load_gan_bundle(model.generator, model.mpd, model.msd, jax.device_get(
        {"g_params": g_params, "d_params": d_params, "d_stats": d_stats}))
    return jax_model, g_params, model, audio


def test_compute_stft_bias_and_denoise_match_jax(hifigan_pair):
    jax_model, g_params, model, audio = hifigan_pair
    want_bias = np.asarray(jax_model.compute_stft_bias(g_params))
    bias = model.compute_stft_bias()
    assert bias.shape == want_bias.shape == (1, 257, 1)
    np.testing.assert_allclose(bias.numpy(), want_bias, rtol=1e-3,
                               atol=1e-4 * np.abs(want_bias).max())
    for strength in (0.0025, 0.5):
        want = jax_model.denoise(g_params, jnp.asarray(audio), strength=strength)
        got = model.denoise(torch.from_numpy(audio), strength=strength)
        _close(got.numpy(), want, f"strength {strength}")
    given = model.denoise(torch.from_numpy(audio), strength=0.5, stft_bias=bias)
    assert torch.equal(given, model.denoise(torch.from_numpy(audio), strength=0.5))
