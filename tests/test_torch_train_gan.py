"""The HiFi-GAN training run of the port: data, runner, checkpoints, bundle.

`VocoderDataset` and `LengthBucketBatchSampler` against the JAX package's
(same crops, same batch order), `train_gan(device="cpu")` at debug widths on
a tiny WAV corpus (checkpoint, resume, `.roar`), the bundle read back by the
JAX package's `restore_from`, and the gradient of the port's mel front end
against `jax.grad` of the JAX one.
"""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from roar_tpu.data.dataset import VocoderDataset as JaxVocoderDataset
from roar_tpu.data.sampling import LengthBucketBatchSampler as JaxSampler
from roar_tpu.models.hifigan_model import HifiGanModel as JaxHifiGanModel
from roar_tpu.ops import spectrogram as jax_spec
from roar_tpu.training.save_restore import restore_from as jax_restore_from
from roar_tpu_torch.config.config import load_config
from roar_tpu_torch.data.audio import write_wav
from roar_tpu_torch.data.dataset import VocoderDataset
from roar_tpu_torch.data.manifest import write_manifest
from roar_tpu_torch.data.sampling import LengthBucketBatchSampler
from roar_tpu_torch.models.hifigan_model import HifiGanModel, generator_from_config
from roar_tpu_torch.ops import spectrogram as port_spec
from roar_tpu_torch.training import convert, run
from roar_tpu_torch.training.save_restore import restore_from

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples" / "tts"))
import hifigan_torch  # noqa: E402  (the port's CLI module)

PCM_LSB = 2  # a last-bit difference in the fp32 audio, as for the serving path
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
    with pytest.raises(NotImplementedError, match="dataset_meta"):
        run.build_vocoder_dataset({"dataset_meta": {}, "sample_rate": SR})


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


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    exp_dir = tmp_path_factory.mktemp("exp")
    cfg = _train_cfg(corpus[0], exp_dir)
    state = hifigan_torch.run(cfg)
    return cfg, state, Path(exp_dir) / "HifiGan"


def test_train_gan_two_steps_checkpoint_and_log(trained):
    cfg, state, root = trained
    assert state.step == 2 and state.g_opt.count == 2 and state.d_opt.count == 2
    assert (root / "checkpoints" / "step_2.pt").exists()
    assert (root / "checkpoints" / "HifiGan.roar").exists()
    records = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "d_loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert all(np.isfinite(r[k]) for k in ("d_loss", "g_loss", "g_mel_loss", "g_fm_loss",
                                               "g_adv_loss", "d_loss_mpd", "d_loss_msd"))
    # CosineAnnealing, warmup_ratio 0.02 of model.max_steps 2.5M: lr * (step + 1) / 50001
    np.testing.assert_allclose([r["lr"] for r in steps], [2e-4 * 1 / 50001, 2e-4 * 2 / 50001],
                               rtol=1e-9)
    assert any("val_g_mel_loss" in r for r in records)


def test_resume_continues_from_the_checkpoint(trained, corpus, tmp_path):
    cfg, state, root = trained
    shutil.copytree(root.parent, tmp_path / "exp")
    again = _train_cfg(corpus[0], tmp_path / "exp", "exp_manager.resume_if_exists=true",
                       "trainer.max_steps=3")
    resumed = hifigan_torch.run(again)
    assert resumed.step == 3 and resumed.g_opt.count == 3
    assert (tmp_path / "exp" / "HifiGan" / "checkpoints" / "step_3.pt").exists()
    adam = resumed.g_opt.optimizer.state_dict()["state"]
    assert all(int(s["step"]) == 3 for s in adam.values())


def test_bundle_is_read_by_the_jax_package_and_serves(trained):
    cfg, state, root = trained
    path = str(root / "checkpoints" / "HifiGan.roar")
    model = state.model
    want = convert.to_jax_tree(model.generator, model.mpd, model.msd)

    jcfg, jtree = jax_restore_from(path)
    assert jcfg["model"]["optim"]["lr"] == 0.0002 and jcfg["trainer"]["max_steps"] == 2
    got_flat, want_flat = flatten_dict(jtree), flatten_dict(want)
    assert set(got_flat) == set(want_flat)
    for key, value in want_flat.items():
        assert got_flat[key].shape == value.shape and got_flat[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got_flat[key], value, err_msg=str(key))
    # the JAX task takes the tree as its own state
    jmodel = JaxHifiGanModel(jcfg["model"])
    mel = np.random.default_rng(4).standard_normal((1, 7, 80)).astype(np.float32)
    jax_audio = np.asarray(jmodel.generator.apply(jtree["g_params"], jnp.asarray(mel)))
    audio = {k: jnp.zeros((2, 2048)) for k in ("y", "y_hat")}
    jmodel.msd.apply({"params": jtree["d_params"]["params"]["msd"],
                      "batch_stats": jtree["d_stats"]["msd"]}, audio["y"], audio["y_hat"])
    jmodel.mpd.apply({"params": jtree["d_params"]["params"]["mpd"]}, audio["y"], audio["y_hat"])

    # the port reads it back, folds the generator and serves the same PCM
    pcfg, ptree = restore_from(path)
    assert pcfg == jcfg
    trainable = HifiGanModel(pcfg["model"]).generator
    convert.load_generator_train_params(trainable, ptree["g_params"])
    folded = trainable.fold_weight_norm()
    served = convert.load_generator_params(
        generator_from_config(pcfg["model"]["generator"], 80), ptree["g_params"])
    with torch.no_grad():
        port_audio = folded(torch.from_numpy(mel)).numpy()
        assert torch.equal(served(torch.from_numpy(mel)), folded(torch.from_numpy(mel)))

    def pcm(x):
        return (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.int32)

    assert np.abs(pcm(port_audio) - pcm(jax_audio)).max() <= PCM_LSB


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


def test_bf16_precision_raises(corpus, tmp_path):
    cfg = _train_cfg(corpus[0], tmp_path, "+trainer.precision=bf16")
    with pytest.raises(NotImplementedError, match="bf16"):
        hifigan_torch.run(cfg)


def test_too_small_corpus_is_diagnosed(corpus, tmp_path):
    cfg = _train_cfg(corpus[0], tmp_path, "model.train_ds.dataloader_params.batch_size=64")
    with pytest.raises(ValueError, match="0 batches"):
        hifigan_torch.run(cfg)


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


def test_chip_smoke_training_phase_rehearsal_on_the_cpu(capsys):
    """The card's training phase at debug widths with the plain versions:
    every check of the phase but the launch counts and the timings."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    out = chip_smoke.phase_train_hifigan(torch.device("cpu"), n_utterances=4, steps=4,
                                         batch_size=2, n_segments=2048, debug=True)
    assert out == {"launches": {"fwd": 0, "dx": 0, "dw": 0}}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [r["step"] for r in lines if r.get("phase") == "train_hifigan"] == [
        "cli", "bundle", "kernel_path_vs_plain_path"]
