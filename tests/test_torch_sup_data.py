"""Sup-data extraction of the port against the JAX package: the extractor,
the priors, `average_features`, the host modules (audio, manifest, config),
the featurizers and the extraction script.

The parity tests run both extractors on the CPU over the same three ragged
utterances at a small configuration (8 kHz, 512-sample frames).  Values are
held at the stage tolerances of tests/test_torch_spectrogram.py and
tests/test_torch_pyin.py; keys, lengths and cache file names must be equal.
jax is imported inside the tests, so that the `cuda`-marked test runs where
jax is not installed.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roar_tpu_torch.data import audio as taudio
from roar_tpu_torch.data import manifest as tmanifest
from roar_tpu_torch.data.sup_data import (CACHED_KINDS, SUP_DATA_TYPES, SupDataConfig,
                                          SupDataExtractor, pitch_statistics)
from roar_tpu_torch.ops import lengths as tlengths
from roar_tpu_torch.ops import priors as tpriors

REPO = Path(__file__).resolve().parents[1]
SMALL_KW = dict(sample_rate=8000, n_fft=512, win_length=512, hop_length=128, n_mels=40,
                highfreq=4000.0, pitch_fmin=80.0, pitch_fmax=400.0)
FILE_IDS = ["spk_a", "spk_b", "spk_c"]


def _utterances(sr=8000, seed=0):
    """Three ragged utterances: a tone with vibrato, silence then a tone with
    a little noise, noise then a tone."""
    rng = np.random.default_rng(seed)

    def tone(f, n):
        t = np.arange(n) / sr
        return 0.4 * np.sin(2 * np.pi * f * t + 2.0 * np.sin(2 * np.pi * 5.0 * t))

    a = tone(150.0, int(0.9 * sr))
    b = np.concatenate([np.zeros(int(0.2 * sr)), tone(220.0, int(0.4 * sr))])
    b = b + 0.005 * rng.standard_normal(len(b))
    c = np.concatenate([0.1 * rng.standard_normal(int(0.25 * sr)), tone(110.0, int(0.5 * sr))])
    return [x.astype(np.float32) for x in (a, b, c)]


@pytest.fixture(scope="module")
def both_extractions(tmp_path_factory):
    from roar_tpu.data.sup_data import SupDataConfig as JaxConfig
    from roar_tpu.data.sup_data import SupDataExtractor as JaxExtractor

    audios = _utterances()
    jdir, tdir = tmp_path_factory.mktemp("jax_sup"), tmp_path_factory.mktemp("torch_sup")
    kw = dict(batch_size=2, audio_pad_multiple=2048)  # two buckets, the second of one row
    want = JaxExtractor(JaxConfig(**SMALL_KW), str(jdir), **kw).extract(audios, FILE_IDS)
    port = SupDataExtractor(SupDataConfig(**SMALL_KW), str(tdir), device="cpu", **kw)
    got = port.extract(audios, FILE_IDS)
    return audios, want, got, jdir, tdir, port


def test_extractor_defaults_to_the_card():
    import inspect

    assert inspect.signature(SupDataExtractor.__init__).parameters["device"].default == "cuda"
    assert SupDataExtractor(SupDataConfig(), device="cpu").device == torch.device("cpu")


def test_sup_data_types_and_configs_match_jax():
    import dataclasses

    from roar_tpu.data import sup_data as jsd

    assert SUP_DATA_TYPES == jsd.SUP_DATA_TYPES
    for kw in ({}, SMALL_KW):
        cfg, jcfg = SupDataConfig(**kw), jsd.SupDataConfig(**kw)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(cfg.mel_config()) == dataclasses.asdict(jcfg.mel_config())
        assert dataclasses.asdict(cfg.pyin_config()) == dataclasses.asdict(jcfg.pyin_config())


def test_extractor_keys_lengths_and_dtypes_match_jax(both_extractions):
    audios, want, got, *_ = both_extractions
    assert len(got) == len(want) == 3
    for audio, w, g in zip(audios, want, got):
        assert set(g) == set(w)
        for key in w:
            assert np.asarray(g[key]).shape == np.asarray(w[key]).shape, key
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key
        # mel and energy are trimmed to the mel length, pitch to the pitch frame count
        assert g["log_mel"].shape == (40, len(audio) // 128 + 1)
        assert g["energy"].shape == (len(audio) // 128 + 1,)
        assert g["pitch"].shape == g["voiced_mask"].shape == g["p_voiced"].shape


def test_extractor_values_match_jax(both_extractions):
    _, want, got, *_ = both_extractions
    for w, g in zip(want, got):
        assert int(g["mel_len"]) == int(w["mel_len"])
        # pure tones leave most mel bins near zero, where log(mel + 1e-5)
        # turns a float32 rounding of 1e-7 into 1e-2: hold mel + 1e-5 itself,
        # and the log where the bin carries energy
        np.testing.assert_allclose(np.exp(g["log_mel"]), np.exp(w["log_mel"]), atol=1e-6, rtol=1e-4)
        loud = w["log_mel"] > -5.0
        np.testing.assert_allclose(g["log_mel"][loud], w["log_mel"][loud], atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(g["energy"], w["energy"], atol=5e-4, rtol=1e-5)
        # pYIN end to end is held statistically (tests/test_torch_pyin.py);
        # on these utterances every frame agrees
        assert (g["voiced_mask"] == w["voiced_mask"]).mean() >= 0.99
        both = g["voiced_mask"] & w["voiced_mask"]
        cents = np.abs(1200.0 * np.log2(g["pitch"][both] / w["pitch"][both]))
        assert both.sum() > 10 and (cents <= 10.0 + 1e-3).mean() >= 0.99
        np.testing.assert_allclose(g["p_voiced"], w["p_voiced"], atol=1e-4)
        assert ((g["pitch"] > 0) == g["voiced_mask"]).all()


def test_extractor_cache_layout_matches_jax(both_extractions):
    _, _, got, jdir, tdir, port = both_extractions

    def listing(root):
        return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())

    assert listing(tdir) == listing(jdir)
    assert listing(tdir) == sorted(f"{kind}/{fid}.npy" for kind in CACHED_KINDS for fid in FILE_IDS)
    for fid, item in zip(FILE_IDS, got):
        for kind in CACHED_KINDS:
            np.testing.assert_array_equal(port.load_cached(kind, fid), item[kind])
            # either package reads what the other wrote
            assert np.load(Path(jdir) / kind / f"{fid}.npy").shape == item[kind].shape
    assert port.load_cached("pitch", "nobody") is None
    assert SupDataExtractor(SupDataConfig(), device="cpu").load_cached("pitch", "spk_a") is None


def test_pitch_statistics_match_jax(both_extractions):
    from roar_tpu.data.sup_data import pitch_statistics as jax_stats

    _, _, got, *_ = both_extractions
    pitches = [g["pitch"] for g in got]
    assert pitch_statistics(pitches) == jax_stats(pitches)
    assert pitch_statistics([]) == jax_stats([])
    assert pitch_statistics([np.zeros(4, np.float32)]) == jax_stats([np.zeros(4, np.float32)])


@pytest.mark.parametrize("p,m,scale", [(7, 19, 1.0), (30, 120, 0.5), (1, 5, 1.0)])
def test_beta_binomial_prior_matches_jax(p, m, scale):
    from roar_tpu.ops import priors as jpriors

    want = np.asarray(jpriors.beta_binomial_prior(p, m, scale))
    got = tpriors.beta_binomial_prior(p, m, scale)
    assert got.shape == (m, p) and got.dtype == torch.float32
    # float32 lgamma of arguments up to a few hundred, differenced and
    # exponentiated: relative rounding of order 1e-4 (measured 2e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-7)
    np.testing.assert_array_equal(tpriors.beta_binomial_prior_np(p, m, scale),
                                  jpriors.beta_binomial_prior_np(p, m, scale))
    np.testing.assert_allclose(got.numpy(), tpriors.beta_binomial_prior_np(p, m, scale),
                               rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-3)


def test_beta_binomial_interpolator_matches_jax():
    from roar_tpu.ops.priors import BetaBinomialInterpolator as JaxInterp

    ours, theirs = tpriors.BetaBinomialInterpolator(), JaxInterp()
    for w, h in ((123, 17), (50, 10), (7, 3)):
        got, want = ours(w, h), theirs(w, h)
        assert got.shape == (w, h) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert ours.round(123, 50) == theirs.round(123, 50) == 100


@pytest.mark.parametrize("float_durs", [False, True])
def test_average_features_matches_jax(float_durs):
    import jax.numpy as jnp

    from roar_tpu.ops.lengths import average_features as jax_average

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 3, 40)).astype(np.float32)
    feats[:, :, 5:9] = 0.0      # an all-zero span
    feats[0, 1, 20] = 0.0       # a zero inside a span is left out of the mean
    if float_durs:
        durs = rng.uniform(0.2, 6.0, (2, 9)).astype(np.float32)
    else:
        durs = np.array([[5, 4, 0, 6, 5, 10, 3, 7, 0], [9, 0, 1, 10, 10, 20, 0, 0, 0]], np.int32)
    want = np.asarray(jax_average(jnp.asarray(feats), jnp.asarray(durs)))
    got = tlengths.average_features(torch.from_numpy(feats), torch.from_numpy(durs))
    assert got.shape == (2, 3, 9)
    # differences of float32 cumulative sums over 40 frames
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if not float_durs:
        # row 0: token 1 spans the all-zero frames, token 2 has no frames; row 1: token 1 has none
        assert (got[0, :, 1] == 0).all() and (got[0, :, 2] == 0).all() and (got[1, :, 1] == 0).all()


def test_audio_and_manifest_match_the_jax_packages_host_code(tmp_path):
    from roar_tpu.data import audio as jaudio
    from roar_tpu.data import manifest as jmanifest

    rng = np.random.default_rng(1)
    x = np.concatenate([np.zeros(3000), 0.5 * np.sin(np.arange(8000) * 0.05),
                        np.zeros(2000)]).astype(np.float32) + 1e-4 * rng.standard_normal(13000)
    path = str(tmp_path / "a.wav")
    taudio.write_wav(path, x, 16000)
    data, sr = taudio.read_wav(path)
    want, want_sr = jaudio.read_wav(path)
    assert sr == want_sr == 16000 and data.dtype == np.float32
    np.testing.assert_array_equal(data, np.asarray(want).reshape(data.shape))
    np.testing.assert_allclose(data, np.clip(x, -1, 1), atol=2.0 / 32767)  # 16-bit PCM, truncated
    np.testing.assert_array_equal(taudio.resample(data, 16000, 22050),
                                  jaudio.resample(data, 16000, 22050))
    assert taudio.resample(data, 16000, 16000) is data
    np.testing.assert_array_equal(taudio.trim_silence(data, 16000, 40.0),
                                  jaudio.trim_silence(data, 16000, 40.0))
    seg = taudio.AudioSegment.from_file(path, target_sr=8000, offset=0.1, duration=0.5, trim=True)
    jseg = jaudio.AudioSegment.from_file(path, target_sr=8000, offset=0.1, duration=0.5, trim=True)
    np.testing.assert_array_equal(seg.samples, jseg.samples)
    assert (seg.sample_rate, seg.num_samples, seg.duration) == \
        (jseg.sample_rate, jseg.num_samples, jseg.duration)

    entries = [{"audio_filepath": path, "text": "வணக்கம்", "duration": 0.8},
               {"audio_filepath": "b.wav", "text": "x", "duration": 12.0}]
    tmanifest.write_manifest(tmp_path / "m.json", entries)
    assert tmanifest.read_manifest(tmp_path / "m.json") == entries
    assert jmanifest.read_manifest(tmp_path / "m.json") == entries
    both = f"{tmp_path / 'm.json'},{tmp_path / 'm.json'}"
    assert tmanifest.read_manifest(both) == entries * 2
    assert tmanifest.filter_by_duration(entries, 0.5, 10.0) == \
        jmanifest.filter_by_duration(entries, 0.5, 10.0)


OVERRIDES = ["manifest_filepath=m.json", "sup_data_path=sup", "batch_size=4", "x.lr=1e-3"]


def test_config_loader_matches_jax_package():
    from roar_tpu.config import load_config as jax_load
    from roar_tpu_torch.config import ConfigError, load_config

    path = REPO / "configs" / "ds_for_fastpitch_align.yaml"
    cfg = load_config(path, overrides=OVERRIDES)
    assert cfg == jax_load(path, overrides=OVERRIDES)
    assert cfg["dataset"]["manifest_filepath"] == "m.json" and cfg["x"]["lr"] == 1e-3
    # an un-overridden mandatory `???` value is dropped; its interpolation raises
    with pytest.raises(ConfigError):
        load_config(path)
    assert "manifest_filepath" not in load_config(path, resolve=False)
    with pytest.raises(ConfigError):
        load_config(path, overrides=["novalue"])
    fp = REPO / "configs" / "fastpitch_22050_align.yaml"
    data = ["train_dataset=t.json", "validation_datasets=v.json", "sup_data_path=s",
            "pitch_mean=0.0", "pitch_std=1.0"]
    assert load_config(fp, overrides=data) == jax_load(fp, overrides=data)


def test_config_package_imports_without_yaml():
    code = ("import sys; import roar_tpu_torch.config.cli, roar_tpu_torch.config; "
            "assert 'yaml' not in sys.modules, 'yaml imported at import time'; print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_chip_smoke_sup_data_config_matches_yaml():
    from roar_tpu_torch.config import load_config

    sys.path.insert(0, str(REPO))
    import chip_smoke

    want = load_config(REPO / "configs" / "ds_for_fastpitch_align.yaml",
                       overrides=["manifest_filepath=m.json", "sup_data_path=sup"])
    got = chip_smoke.sup_data_config("m.json", "sup")
    assert got.pop("device") == "cuda"
    for key, value in got["dataset"].items():
        assert want["dataset"][key] == value, key
    assert got["batch_size"] == want["batch_size"] == 16
    assert got["audio_pad_multiple"] == want["audio_pad_multiple"] == 16384
    cfg = SupDataConfig()
    assert (cfg.sample_rate, cfg.n_fft, cfg.win_length, cfg.hop_length, cfg.n_mels,
            cfg.highfreq) == tuple(want["dataset"][k] for k in (
                "sample_rate", "n_fft", "win_length", "hop_length", "n_mels", "highfreq"))


def test_chip_smoke_synthetic_utterance_meets_its_own_truth_bars():
    """The card run's generator and scoring, rehearsed on the CPU with one
    short utterance at the production widths."""
    from roar_tpu_torch.ops.pyin import PyinConfig, pyin

    sys.path.insert(0, str(REPO))
    import chip_smoke

    audio, f0_true, voiced_true, score = chip_smoke.synth_utterance(np.random.default_rng(0), 2.0)
    assert audio.dtype == np.float32 and len(audio) == 44100 and np.abs(audio).max() <= 1.0
    assert f0_true.shape == voiced_true.shape == score.shape == (44100 // 512 + 1,)
    assert voiced_true.any() and not voiced_true.all() and score.sum() > 30
    f0, voiced, _ = pyin(torch.from_numpy(audio)[None], torch.tensor([len(audio)]), PyinConfig())
    result = chip_smoke.score_against_truth([f0[0].numpy()], [voiced[0].numpy()],
                                            [(f0_true, voiced_true, score)])
    chip_smoke.check_truth_bars(result)
    with pytest.raises(AssertionError):
        chip_smoke.check_truth_bars({**result, "voicing_agreement": 0.5})
    log_obs = chip_smoke.viterbi_log_obs(np.random.default_rng(0), 2, 5, 30, ties=True)
    assert log_obs.shape == (2, 5, 60) and log_obs.min() == -700.0
    assert (log_obs[0] == log_obs[0, 0, 0]).all() and (log_obs[1] == log_obs[1, :1]).all()


def test_cli_subprocess_on_cpu(tmp_path):
    """The extraction script end to end at the production config, on the CPU:
    same printed lines and cache files as the JAX script."""
    wavs = tmp_path / "spk0"
    wavs.mkdir()
    entries = []
    for i, audio in enumerate(_utterances(sr=22050, seed=3)):
        path = wavs / f"u{i}.wav"
        taudio.write_wav(str(path), audio, 22050)
        entries.append({"audio_filepath": str(path), "text": "x", "duration": len(audio) / 22050})
    tmanifest.write_manifest(tmp_path / "manifest.json", entries)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts/dataset_processing/tts/extract_sup_data_torch.py"),
         "--config-name=ds_for_fastpitch_align", f"manifest_filepath={tmp_path / 'manifest.json'}",
         f"sup_data_path={tmp_path / 'sup'}", "device=cpu", "batch_size=2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "Extracting sup-data for 3 utterances ..."
    assert lines[-2].startswith("PITCH_MEAN=") and ", PITCH_STD=" in lines[-2]
    assert lines[-1].startswith("PITCH_MIN=") and ", PITCH_MAX=" in lines[-1]
    mean = float(lines[-2].split("=")[1].split(",")[0])
    assert 100.0 < mean < 230.0  # tones at 110, 150 and 220 Hz
    for kind in CACHED_KINDS:
        assert sorted(p.name for p in (tmp_path / "sup" / kind).iterdir()) == \
            ["spk0_u0.npy", "spk0_u1.npy", "spk0_u2.npy"]
    pitch = np.load(tmp_path / "sup" / "pitch" / "spk0_u0.npy")
    assert pitch.shape == (len(_utterances(sr=22050, seed=3)[0]) // 512 + 1,)
    assert np.abs(np.median(pitch[pitch > 0]) - 150.0) < 3.0


def test_featurizers_and_processors_match_jax(tmp_path):
    from roar_tpu.data import featurizers as jfeat
    from roar_tpu_torch.data import featurizers as tfeat

    audio = _utterances()[1]
    entry = {"audio_filepath": "/data/spk/u7.wav"}
    assert tfeat._feature_path(tmp_path, "pitch", entry) == jfeat._feature_path(tmp_path, "pitch", entry)
    feat = tfeat.PitchFeaturizer(SupDataConfig(**SMALL_KW), str(tmp_path / "f"), device="cpu")
    feat.setup()
    feat.save(entry, audio)
    loaded = feat.load(entry)
    assert set(loaded) == {"pitch", "voiced_mask", "p_voiced"}
    assert loaded["pitch"].shape == (len(audio) // 128 + 1,)
    mel = tfeat.MelSpectrogramFeaturizer(SupDataConfig(**SMALL_KW), str(tmp_path / "f"), device="cpu")
    mel.setup()
    mel.save(entry, audio)
    assert mel.load(entry)["log_mel"].shape == (40, len(audio) // 128 + 1)
    assert tfeat.EnergyFeaturizer.feature_names == jfeat.EnergyFeaturizer.feature_names

    stats = tmp_path / "stats.json"
    stats.write_text(json.dumps({"default": {"pitch_mean": 150.0, "pitch_std": 30.0},
                                 "7": {"pitch_mean": 100.0, "pitch_std": 10.0}}))
    procs = [("FeatureScaler", dict(field="pitch", add_value=1.0, div_value=2.0)),
             ("LogCompression", dict(field="energy")),
             ("LogCompression", dict(field="energy", log_zero_guard_type="clamp",
                                     log_zero_guard_value=0.5)),
             ("MeanVarianceNormalization", dict(field="pitch", stats_path=str(stats))),
             ("MeanVarianceSpeakerNormalization", dict(field="pitch", stats_path=str(stats)))]
    for name, kw in procs:
        examples = [{"pitch": loaded["pitch"].copy(), "voiced_mask": loaded["voiced_mask"],
                     "energy": np.abs(loaded["p_voiced"]) + 0.1, "speaker_id": 7} for _ in range(2)]
        getattr(tfeat, name)(**kw).process(examples[0])
        getattr(jfeat, name)(**kw).process(examples[1])
        for key in examples[0]:
            np.testing.assert_array_equal(examples[0][key], examples[1][key])
    with pytest.raises(ValueError):
        tfeat.MeanVarianceSpeakerNormalization(
            "pitch", str(stats), fallback_to_default=False).process({"pitch": 1.0, "speaker_id": 9})


@pytest.mark.cuda
def test_cuda_extractor_agrees_with_cpu_extractor():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Viterbi kernels have no CPU mode")
    from roar_tpu_torch.kernels import pyin_viterbi as pv

    audios = _utterances(sr=22050, seed=4)
    cpu = SupDataExtractor(SupDataConfig(), batch_size=4, device="cpu").extract(audios)
    before = (pv.LAUNCHES_FWD, pv.LAUNCHES_BACKTRACK)
    gpu = SupDataExtractor(SupDataConfig(), batch_size=4).extract(audios)  # device="cuda"
    assert (pv.LAUNCHES_FWD, pv.LAUNCHES_BACKTRACK) == (before[0] + 1, before[1] + 1)
    for c, g in zip(cpu, gpu):
        # cuFFT against the CPU FFT: float32 rounding, held on mel + 1e-5
        # itself (see test_extractor_values_match_jax)
        np.testing.assert_allclose(np.exp(g["log_mel"]), np.exp(c["log_mel"]), atol=1e-6, rtol=1e-3)
        np.testing.assert_allclose(g["energy"], c["energy"], atol=1e-3, rtol=1e-4)
        assert (g["voiced_mask"] == c["voiced_mask"]).mean() >= 0.99
