"""STFT / log-mel front end of the port against the JAX package.

Same inputs (numpy, seeded) through roar_tpu.ops.spectrogram and
roar_tpu_torch.ops.spectrogram on the CPU.  The static tables (mel
filterbank, windows) must be bit-identical; the transforms agree within
float32 rounding: the JAX op is a windowed-DFT matrix product, the port is
`torch.stft` (an FFT), so sums run in another order.  jax is imported inside
the tests, so that the module imports where jax is not installed.
"""

import numpy as np
import pytest
import torch

from roar_tpu_torch.ops import spectrogram as ts

# |STFT| of unit-scale audio at n_fft <= 2048 reaches a few hundred; the FFT
# and the DFT product differ by float32 rounding of sums of n_fft terms.
# Measured on these inputs: max |diff| 1.4e-4 on magnitudes up to 2.5e2
# (DESIGN §2's bar against torch.stft is atol 2e-3).
STFT_TOL = dict(atol=5e-4, rtol=1e-5)
# log(mel + guard) and its normalised forms; measured max |diff| 1.6e-5
LOGMEL_TOL = dict(atol=1e-4, rtol=1e-5)


def _audio(seed=0, b=3, s=6000):
    rng = np.random.default_rng(seed)
    t = np.arange(s) / 8000.0
    x = 0.3 * rng.standard_normal((b, s)) + 0.5 * np.sin(2 * np.pi * 220.0 * t)[None]
    return x.astype(np.float32)


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale_matches_jax_package(htk):
    from roar_tpu.ops import spectrogram as js

    f = np.linspace(0.0, 11025.0, 257)
    np.testing.assert_array_equal(ts.hz_to_mel(f, htk), js.hz_to_mel(f, htk))
    m = np.linspace(0.0, 60.0, 257)
    np.testing.assert_array_equal(ts.mel_to_hz(m, htk), js.mel_to_hz(m, htk))


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax,norm", [
    (22050, 2048, 80, 0.0, 8000.0, "slaney"),
    (22050, 1024, 80, 0.0, None, "slaney"),
    (16000, 512, 64, 20.0, 7600.0, None),
    (44100, 2048, 128, 0.0, 16000.0, "slaney"),
])
def test_mel_filterbank_bit_identical(sr, n_fft, n_mels, fmin, fmax, norm):
    from roar_tpu.ops import spectrogram as js

    got = ts.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, norm)
    want = js.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, norm)
    assert got.dtype == np.float32 and got.shape == (n_mels, n_fft // 2 + 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", ["hann", "hamming", "blackman", "bartlett", "none"])
def test_windows_bit_identical(window):
    from roar_tpu.ops import spectrogram as js

    for n in (2, 400, 1024, 2048):
        np.testing.assert_array_equal(ts.get_window(window, n), js.get_window(window, n))
    # the zero-padded, centred window is the window the JAX DFT matrix folds
    # in: its column for frequency 0 is the window itself (cos 0 = 1)
    for n_fft, win in ((2048, 2048), (1024, 800), (512, 401)):
        want = js._windowed_dft_matrix(n_fft, win, window)[:, 0]
        np.testing.assert_array_equal(ts._padded_window_np(n_fft, win, window), want)


def test_unknown_window_and_norm_raise():
    with pytest.raises(ValueError):
        ts.get_window("kaiser", 16)
    with pytest.raises(ValueError):
        ts.mel_filterbank(16000, 512, 40, norm="l1")
    with pytest.raises(ValueError):
        ts.MelConfig(exact_pad=True, n_window_stride=161)
    with pytest.raises(ValueError):
        ts.MelConfig(log_zero_guard_type="floor")


@pytest.mark.parametrize("n_fft,hop,win,window,center,exact_pad", [
    (2048, 512, 2048, "hann", True, False),   # the sup-data shape
    (1024, 256, 1024, "hann", True, False),   # the vocoder shape
    (512, 160, 400, "hamming", True, False),  # window shorter than n_fft, hop not dividing
    (512, 128, 512, "hann", False, True),     # exact_pad
    (256, 64, 256, "blackman", False, False),  # no padding at all
])
def test_stft_magnitude_matches_jax(n_fft, hop, win, window, center, exact_pad):
    import jax.numpy as jnp

    from roar_tpu.ops import spectrogram as js

    x = _audio()
    want = np.asarray(js.stft_magnitude(jnp.asarray(x), n_fft, hop, win, window, center, exact_pad))
    got = ts.stft_magnitude(torch.from_numpy(x), n_fft, hop, win, window, center, exact_pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **STFT_TOL)


def test_stft_magnitude_takes_one_utterance_and_mag_eps():
    import jax.numpy as jnp

    from roar_tpu.ops import spectrogram as js

    x = _audio(b=1)[0]
    want = np.asarray(js.stft_magnitude(jnp.asarray(x), 512, 128, 512, mag_eps=1e-5))
    got = ts.stft_magnitude(torch.from_numpy(x), 512, 128, 512, mag_eps=1e-5).numpy()
    assert got.shape == want.shape == (1, 257, 6000 // 128 + 1)
    np.testing.assert_allclose(got, want, **STFT_TOL)


def test_frame_signal_and_frame_count():
    from roar_tpu.ops import spectrogram as js

    x = torch.arange(40.0)[None]
    frames = ts.frame_signal(x, 16, 8)
    assert frames.shape == (1, 4, 16)
    assert torch.equal(frames[0, 2], torch.arange(16.0, 32.0))
    for n in (0, 511, 512, 22050):
        assert ts.stft_frame_count(n, 2048, 512, 1024) == js.stft_frame_count(n, 2048, 512, 1024)
        assert ts.stft_frame_count(n, 2048, 512, 1024) == n // 512 + 1


def _both_log_mel(cfg_kwargs, x, lens, **call):
    import jax.numpy as jnp

    from roar_tpu.ops import spectrogram as js

    want, want_len = js.log_mel_spectrogram(jnp.asarray(x), jnp.asarray(lens),
                                            js.MelConfig(**cfg_kwargs), **call)
    got, got_len = ts.log_mel_spectrogram(torch.from_numpy(x), torch.from_numpy(lens),
                                          ts.MelConfig(**cfg_kwargs), **call)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape
    return got.numpy(), np.asarray(want)


SUP_DATA_MEL = dict(sample_rate=22050, n_window_size=2048, n_window_stride=512, n_fft=2048,
                    nfilt=80, lowfreq=0.0, highfreq=8000.0, preemph=None, normalize=None,
                    mag_power=1.0, log_zero_guard_value=1e-5, dither=0.0, pad_to=1)


def test_log_mel_sup_data_settings_match_jax():
    x = _audio(s=9000)
    lens = np.array([9000, 7000, 4321], np.int32)
    got, want = _both_log_mel(SUP_DATA_MEL, x, lens)
    np.testing.assert_allclose(got, want, **LOGMEL_TOL)
    # frames beyond each utterance's length are masked to pad_value
    for j, n in enumerate(lens // 512 + 1):
        assert (got[j, :, n:] == 0.0).all()


@pytest.mark.parametrize("normalize", ["per_feature", "all_features", None])
@pytest.mark.parametrize("guard", ["add", "clamp"])
def test_log_mel_general_settings_match_jax(normalize, guard):
    """Preemphasis, power 2, normalisation with the unbiased std, the clamp
    guard and pad_to 16: the training preprocessor's path."""
    x = _audio(seed=1, s=5000)
    lens = np.array([5000, 3333, 1600], np.int32)
    cfg = dict(sample_rate=8000, n_window_size=400, n_window_stride=160, nfilt=40,
               normalize=normalize, log_zero_guard_type=guard, pad_to=16, pad_value=-3.0)
    got, want = _both_log_mel(cfg, x, lens)
    assert got.shape[-1] % 16 == 0
    # normalised features are O(1): divided by a std of order 1
    np.testing.assert_allclose(got, want, **LOGMEL_TOL)


def test_linear_spec_and_no_log_match_jax():
    x = _audio(seed=2, s=4000)
    lens = np.array([4000, 4000, 2000], np.int32)
    cfg = dict(sample_rate=8000, n_window_size=256, n_window_stride=64, nfilt=32, normalize=None,
               preemph=None, mag_power=2.0)
    got, want = _both_log_mel(cfg, x, lens, linear_spec=True)
    # power spectrum: values up to 1e5, so the relative bar carries it
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-4)
    got, want = _both_log_mel({**cfg, "log": False}, x, lens)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-4)


def test_frame_energy_matches_jax():
    import jax.numpy as jnp

    from roar_tpu.ops import spectrogram as js

    x = _audio(seed=3, s=9000)
    want = np.asarray(js.frame_energy(jnp.asarray(x), js.MelConfig(**SUP_DATA_MEL)))
    got = ts.frame_energy(torch.from_numpy(x), ts.MelConfig(**SUP_DATA_MEL)).numpy()
    assert got.shape == want.shape == (3, 9000 // 512 + 1)
    # an L2 norm over 1025 bins of values that agree to STFT_TOL; measured
    # max |diff| 9.2e-5 on energies up to 4.3e2
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-5)


def test_preemphasis_and_normalize_batch_match_jax():
    import jax.numpy as jnp

    from roar_tpu.ops import spectrogram as js

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 50)).astype(np.float32)
    np.testing.assert_allclose(ts.preemphasis(torch.from_numpy(x), 0.97).numpy(),
                               np.asarray(js.preemphasis(jnp.asarray(x), 0.97)), atol=1e-7)
    feats = rng.standard_normal((3, 5, 20)).astype(np.float32)
    lens = np.array([20, 7, 1], np.int32)  # one valid frame: the n - 1 guard
    for kind in ("per_feature", "all_features"):
        want = np.asarray(js.normalize_batch(jnp.asarray(feats), jnp.asarray(lens), kind))
        got = ts.normalize_batch(torch.from_numpy(feats), torch.from_numpy(lens), kind).numpy()
        # sums of at most 100 float32 terms, then a division by std + 1e-5
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):
        ts.normalize_batch(torch.from_numpy(feats), torch.from_numpy(lens), "global")


def test_dither_needs_training_and_an_explicit_generator():
    x = torch.from_numpy(_audio(seed=5, s=3000))
    lens = torch.tensor([3000, 3000, 3000])
    cfg = ts.MelConfig(sample_rate=8000, n_window_size=256, n_window_stride=64, nfilt=32,
                       dither=1e-2, normalize=None)
    plain, _ = ts.log_mel_spectrogram(x, lens, cfg)
    no_gen, _ = ts.log_mel_spectrogram(x, lens, cfg, training=True)
    not_training, _ = ts.log_mel_spectrogram(
        x, lens, cfg, dither_generator=torch.Generator().manual_seed(0))
    assert torch.equal(plain, no_gen) and torch.equal(plain, not_training)
    a, _ = ts.log_mel_spectrogram(x, lens, cfg, training=True,
                                  dither_generator=torch.Generator().manual_seed(0))
    b, _ = ts.log_mel_spectrogram(x, lens, cfg, training=True,
                                  dither_generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, plain)


def test_full_fp32_matmul_restores_the_callers_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with ts.full_fp32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
