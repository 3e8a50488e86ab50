"""The HiFi-GAN training run of the port: data, config, bundle format, mel
front end.

`VocoderDataset` and `LengthBucketBatchSampler` against the JAX package's
(same crops, same batch order), the validation-set naming, the threaded batch
iterator, the msgpack writer of `.roar` bundles, the gradient of the port's
mel front end against `jax.grad` of the JAX one, and chip_smoke.py's training
config against the YAML.  The runner's own run (`train_gan(device="cpu")`:
checkpoint, resume, `.roar`) is in tests/test_torch_train_gan_cli.py, the
rehearsal of chip_smoke.py's training phase in
tests/test_torch_train_gan_rehearsal.py.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu.data.dataset import VocoderDataset as JaxVocoderDataset
from roar_tpu.data.sampling import LengthBucketBatchSampler as JaxSampler
from roar_tpu.models.hifigan_model import HifiGanModel as JaxHifiGanModel
from roar_tpu.ops import spectrogram as jax_spec
from roar_tpu_torch.config.config import load_config
from roar_tpu_torch.data.audio import write_wav
from roar_tpu_torch.data.dataset import VocoderDataset
from roar_tpu_torch.data.manifest import write_manifest
from roar_tpu_torch.data.sampling import LengthBucketBatchSampler
from roar_tpu_torch.models.hifigan_model import HifiGanModel
from roar_tpu_torch.ops import spectrogram as port_spec
from roar_tpu_torch.training import run

REPO = Path(__file__).resolve().parents[1]
SR = 22050


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten tones of 0.3 to 1.2 s with noise, 16-bit WAVs and a manifest."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    entries = []
    for i in range(10):
        n = int(SR * rng.uniform(0.3, 1.2))
        audio = (0.3 * np.sin(2 * np.pi * 110 * (i + 1) * np.arange(n) / SR)
                 + 0.01 * rng.standard_normal(n)).astype(np.float32)
        path = str(root / f"utt{i}.wav")
        write_wav(path, audio, SR)
        entries.append({"audio_filepath": path, "duration": n / SR})
    manifest = str(root / "train_manifest.json")
    write_manifest(manifest, entries)
    return manifest, entries


@pytest.mark.parametrize("n_segments", [4096, 16384, None])
def test_vocoder_dataset_crops_match_jax(corpus, n_segments):
    manifest, _ = corpus
    kwargs = dict(manifest_filepath=manifest, sample_rate=SR, n_segments=n_segments,
                  min_duration=0.4, seed=3)
    want_ds, got_ds = JaxVocoderDataset(**kwargs), VocoderDataset(**kwargs)
    assert len(got_ds) == len(want_ds) < 10  # the duration filter dropped some
    assert got_ds.lengths == want_ds.lengths
    order = [0, 3, 1, 3, 2, 0]
    want = want_ds.collate([want_ds[i] for i in order])
    got = got_ds.collate([got_ds[i] for i in order])
    assert set(got) == set(want) == {"audio", "audio_len"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=3), dict(batch_size=3, shuffle=False, drop_last=False),
    dict(batch_size=2, seed=5), dict(batch_size=2, num_shards=2, shard_rank=1),
], ids=["shuffled", "ordered_keep_last", "seed", "sharded"])
def test_sampler_batches_match_jax(kwargs):
    lengths = np.random.default_rng(1).uniform(0.5, 9.0, 23)
    want, got = JaxSampler(lengths, **kwargs), LengthBucketBatchSampler(lengths, **kwargs)
    for epoch in (0, 1, 7):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        assert list(got) == list(want) and len(got) == len(want)


def test_validation_set_naming_and_dataset_by_role(corpus, tmp_path):
    manifest, entries = corpus
    assert run.parse_dataset_as_name("dev-clean_manifest.json") == "dev_clean_.json_"
    assert run.parse_dataset_as_name(manifest) == "train_"
    with pytest.raises(ValueError, match="empty dataloader name"):
        run.parse_dataset_as_name("manifest")
    other = str(tmp_path / "val-other.json")
    write_manifest(other, entries[:3])
    ds_cfg = {"_target_": "roar_tpu.data.dataset.VocoderDataset", "sample_rate": SR,
              "manifest_filepath": f"{manifest},{other}"}
    sets = run.build_validation_datasets(ds_cfg, run.build_vocoder_dataset)
    assert list(sets) == ["train_", "val_other_"]
    assert all(isinstance(d, VocoderDataset) for d in sets.values())  # the port's class
    assert run._val_sets(sets, {"validation_ds": {"val_dl_idx": 1}})[1] == 1
    with pytest.raises(ValueError, match="out of range"):
        run._val_sets(sets, {"validation_ds": {"val_dl_idx": 2}})
    # a dataset_meta block builds the dataset_meta family (tests/test_torch_vocoder_dataset.py)
    meta = run.build_vocoder_dataset({"dataset_meta": {}, "sample_rate": SR})
    assert type(meta).__module__ == "roar_tpu_torch.data.vocoder_dataset" and len(meta) == 0


def test_batch_iterator_threads_keep_the_order(corpus):
    manifest, _ = corpus
    ds = VocoderDataset(manifest, SR, n_segments=None)
    sampler = LengthBucketBatchSampler(ds.lengths, batch_size=3, shuffle=False, drop_last=False)
    plain = list(run.batch_iterator(ds, sampler))
    threaded = list(run.batch_iterator(ds, sampler, num_workers=3))
    assert len(plain) == len(threaded) == 4
    for a, b in zip(plain, threaded):
        np.testing.assert_array_equal(a["audio"], b["audio"])


def _train_cfg(manifest, exp_dir, *extra):
    return load_config(REPO / "configs" / "hifigan_22050.yaml", overrides=[
        f"train_dataset={manifest}", f"validation_datasets={manifest}", "model.debug=true",
        "model.generator.upsample_initial_channel=32", "train_n_segments=2048",
        "train_min_duration=0.1", "val_n_segments=4096", "val_min_duration=0.1",
        "model.train_ds.dataloader_params.batch_size=2",
        "model.train_ds.dataloader_params.num_workers=0",
        "model.validation_ds.dataloader_params.num_workers=0",
        "trainer.max_steps=2", "trainer.log_every_n_steps=1", "trainer.check_val_every_n_epoch=1",
        f"exp_manager.exp_dir={exp_dir}", "+exp_manager.always_save_roar=true", "+device=cpu",
        *extra])


def test_msgpack_serialize_writes_flax_bytes():
    from flax import serialization

    from roar_tpu_torch.training.save_restore import msgpack_restore, msgpack_serialize

    rng = np.random.default_rng(6)
    tree = {"g_params": {"params": {"conv": {"kernel": rng.standard_normal((3, 2, 4)).astype(
        np.float32), "bias": np.zeros(4, np.float32)}, "wrap": {"conv/kernel/scale": np.ones(4, np.float32)}}},
            "d_stats": {"msd": {"sigma": np.asarray(1.5, np.float32),
                                "count": np.arange(3, dtype=np.int32)}}}
    blob = msgpack_serialize(tree)
    assert blob == serialization.msgpack_serialize(tree)
    back = msgpack_restore(blob)
    assert back["d_stats"]["msd"]["sigma"].shape == ()
    np.testing.assert_array_equal(back["g_params"]["params"]["conv"]["kernel"],
                                  tree["g_params"]["params"]["conv"]["kernel"])
    as_torch = {"a": {"w": torch.from_numpy(tree["g_params"]["params"]["conv"]["kernel"])}}
    assert msgpack_serialize(as_torch) == serialization.msgpack_serialize(
        {"a": {"w": tree["g_params"]["params"]["conv"]["kernel"]}})
    with pytest.raises(TypeError, match="cannot store"):
        msgpack_serialize({"a": object()})


@pytest.mark.parametrize("highfreq", [8000, None], ids=["input_mel", "target_mel"])
def test_mel_gradient_matches_jax(highfreq):
    """d sum(mel * cot) / d audio through the exact_pad, clamp-guarded,
    use_grads front end of configs/hifigan_22050.yaml."""
    pre = load_config(REPO / "configs" / "hifigan_22050.yaml", overrides=[
        "train_dataset=t", "validation_datasets=v"])["model"]["preprocessor"]
    jcfg = dataclasses.replace(JaxHifiGanModel({"preprocessor": pre}).mel_cfg, highfreq=highfreq)
    pcfg = dataclasses.replace(HifiGanModel({"preprocessor": pre, "debug": True}).mel_cfg,
                               highfreq=highfreq)
    rng = np.random.default_rng(5)
    audio = (0.2 * rng.standard_normal((2, 4096))).astype(np.float32)
    audio[1, 3000:] = 0.0  # silence: the clamp guard's flat region
    lens = np.array([4096, 3000], np.int32)
    want_mel, _ = jax_spec.log_mel_spectrogram(jnp.asarray(audio), jnp.asarray(lens), jcfg)
    cot = rng.standard_normal(want_mel.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(
        jax_spec.log_mel_spectrogram(a, jnp.asarray(lens), jcfg)[0] * cot))(jnp.asarray(audio))

    x = torch.from_numpy(audio).requires_grad_()
    mel, _ = port_spec.log_mel_spectrogram(x, torch.from_numpy(lens), pcfg)
    np.testing.assert_allclose(mel.detach().numpy(), np.asarray(want_mel), atol=2e-4, rtol=1e-4)
    (mel * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(want)
    assert np.abs(want).max() > 1.0  # the gradient is not trivially zero
    # fp32 FFT on one side, a DFT matrix product on the other
    np.testing.assert_allclose(x.grad.numpy(), want, atol=2e-3 * np.abs(want).max(), rtol=2e-3)


def _assert_subdict(small, big, path=""):
    for key, value in small.items():
        assert key in big, f"{path}{key} not in the YAML"
        if isinstance(value, dict):
            _assert_subdict(value, big[key], f"{path}{key}.")
        else:
            assert value == big[key], f"{path}{key}: {value!r} != {big[key]!r}"


def test_chip_smoke_training_config_matches_yaml():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    yaml_cfg = load_config(REPO / "configs" / "hifigan_22050.yaml", overrides=[
        "train_dataset=m.json", "validation_datasets=m.json", "trainer.max_steps=8",
        "trainer.log_every_n_steps=1", "+trainer.max_epochs=2", "exp_manager.exp_dir=e",
        "+exp_manager.always_save_roar=true", "+device=cuda"])
    _assert_subdict(chip_smoke.hifigan_train_config("m.json", "e"), yaml_cfg)
    shapes = chip_smoke.msd_grouped_shapes()
    assert len(shapes) == 15 and shapes[0] == (32, 8192, 128, 128, 41, 2, 4, 20)
    assert [s[1] for s in shapes[5:10]] == [4097, 2049, 1025, 257, 65]
    assert [s[1] for s in shapes[10:]] == [2049, 1025, 513, 129, 33]
