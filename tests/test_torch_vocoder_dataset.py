"""The `dataset_meta` VocoderDataset (configs/hifigan_dataset/), port against
the JAX package, on the cases of tests/test_data.py's new-style vocoder
dataset tests: for one seed the same items (crops, truncation, processors),
the same weighted sampler indices and the same collated batches; the same
failure after the IO retries; `run.build_vocoder_dataset` dispatching the
recipe's block to it.  Then chip_smoke.py's `train_hifigan_dataset` phase
rehearsed on the CPU: the recipe's YAML through the port's loader and the
HiFi-GAN CLI, 2 steps at debug widths.
"""

import json
import wave

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu_torch.data.vocoder_dataset import VocoderDataset
from roar_tpu_torch.training import run

SR = 22050


def _corpus(tmp_path, n=3):
    """n tones of 1.0 to 1.4 s as 16-bit WAVs and their manifest."""
    entries = []
    for i in range(n):
        t = np.arange(int(SR * (1.0 + 0.2 * i))) / SR
        x = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t) * 32767).astype(np.int16)
        p = tmp_path / f"v{i}.wav"
        with wave.open(str(p), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes(x.tobytes())
        entries.append({"audio_filepath": str(p), "text": "x", "duration": len(t) / SR})
    mf = tmp_path / "v.json"
    mf.write_text("".join(json.dumps(e) + "\n" for e in entries))
    return mf


def _pair(**kwargs):
    from roar_tpu.data.vocoder_dataset import VocoderDataset as JaxVocoderDataset

    return VocoderDataset(**kwargs), JaxVocoderDataset(**kwargs)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, (list, str)):
            assert got[k] == v, k
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("n_samples,audio_multiple", [(4096, 1024), (None, 1024), (30000, 4096)])
def test_items_weights_and_batches_match_jax(tmp_path, n_samples, audio_multiple):
    mf = _corpus(tmp_path)
    meta = {"a": {"manifest_path": str(mf), "audio_dir": str(tmp_path), "sample_weight": 3.0},
            "b": {"manifest_path": str(mf), "audio_dir": str(tmp_path)}}
    ours, theirs = _pair(dataset_meta=meta, sample_rate=SR, n_samples=n_samples,
                         weighted_sampling_steps_per_epoch=5, audio_multiple=audio_multiple,
                         seed=4)
    assert len(ours) == len(theirs) == 6
    assert ours.sample_weights == theirs.sample_weights and ours.lengths == theirs.lengths
    for _ in range(2):  # two epochs of crops from the one generator
        for i in range(len(ours)):
            _assert_same(ours[i], theirs[i])
        np.testing.assert_array_equal(ours.get_sampler_indices(2), theirs.get_sampler_indices(2))
        items = [ours[i] for i in (0, 4, 2)]
        _assert_same(ours.collate(items), theirs.collate([theirs[i] for i in (0, 4, 2)]))
    batch = ours.collate(items)
    assert batch["audio"].shape[1] % audio_multiple == 0
    assert not any(p.startswith("/") for p in batch["audio_filepaths"])


def test_trunc_and_processors_match_jax(tmp_path):
    class Doubler:
        def process(self, example):
            example["audio"] = example["audio"] * 2.0

    mf = _corpus(tmp_path)
    ours, theirs = _pair(dataset_meta={"a": {"manifest_path": str(mf),
                                             "audio_dir": str(tmp_path)}},
                         sample_rate=SR, trunc_duration=0.25, feature_processors={"x2": Doubler()},
                         min_duration=1.1)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        _assert_same(ours[i], theirs[i])
    assert ours[0]["audio"].shape[0] == int(0.25 * SR) and abs(ours[0]["audio"]).max() > 0.5


def test_missing_audio_raises_after_retries(tmp_path):
    mf = tmp_path / "bad.json"
    mf.write_text(json.dumps({"audio_filepath": "nope.wav", "duration": 1.0}) + "\n")
    for ds in _pair(dataset_meta={"a": {"manifest_path": str(mf), "audio_dir": str(tmp_path)}},
                    sample_rate=SR, num_audio_retries=2):
        with pytest.raises(ValueError, match="Failed to read audio"):
            ds[0]


def test_build_vocoder_dataset_dispatches_the_dataset_meta_block(tmp_path):
    mf = _corpus(tmp_path)
    block = {"_target_": "roar_tpu.data.vocoder_dataset.VocoderDataset",
             "dataset_meta": {"a": {"manifest_path": str(mf), "audio_dir": str(tmp_path)}},
             "sample_rate": SR, "n_samples": 8192, "weighted_sampling_steps_per_epoch": None}
    ds = run.build_vocoder_dataset(block)
    assert isinstance(ds, VocoderDataset) and ds.weighted_sampling_steps_per_epoch is None
    assert ds.collate([ds[0], ds[1]], run.BucketSpec())["audio"].shape == (2, 8192)
    classic = run.build_vocoder_dataset({"_target_": "roar_tpu.data.dataset.VocoderDataset",
                                         "manifest_filepath": str(mf), "sample_rate": SR})
    assert not isinstance(classic, VocoderDataset)


def test_dataset_meta_recipe_trains_on_the_cpu():
    """chip_smoke.py's phase, rehearsed: configs/hifigan_dataset/hifigan_22050.yaml
    (bf16-mixed as it ships), 2 steps of batch 2 x 2048 at debug widths;
    finite losses, the ExponentialLR schedule, the bundle, and one step on the
    kernels' plain versions held to itself."""
    import chip_smoke as cs

    out = cs.phase_train_hifigan(torch.device("cpu"), n_utterances=4, steps=2, batch_size=2,
                                 n_segments=2048, debug=True, dataset_meta=True)
    assert set(out["launches"]) == {"fwd", "dx", "dw"}
