"""The HiFi-GAN training run of the port, through its CLI module.

`train_gan(device="cpu")` at debug widths on the tiny WAV corpus of
tests/test_torch_train_gan.py: two steps with their log, the checkpoint and
its resume, the `.roar` bundle read by the JAX package's `restore_from` and
served, the checkpoint's layout, and the runner's refusals (bf16, a corpus too
small for one batch).
"""

import json
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_train_gan import _train_cfg, corpus  # noqa: F401  (the fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu.models.hifigan_model import HifiGanModel as JaxHifiGanModel
from roar_tpu.training.save_restore import restore_from as jax_restore_from
from roar_tpu_torch.models.hifigan_model import HifiGanModel, generator_from_config
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.save_restore import restore_from

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples" / "tts"))
import hifigan_torch  # noqa: E402  (the port's CLI module)

PCM_LSB = 2  # a last-bit difference in the fp32 audio, as for the serving path


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


def test_bf16_precision_raises(corpus, tmp_path, monkeypatch):
    """bf16 trains HiFi-GAN (tests/test_torch_bf16_tts.py); the runner still
    refuses it, by the task's name, for a task without `set_compute_dtype`."""
    from roar_tpu_torch.models.hifigan_model import HifiGanModel

    monkeypatch.delattr(HifiGanModel, "set_compute_dtype")
    cfg = _train_cfg(corpus[0], tmp_path, "+trainer.precision=bf16")
    with pytest.raises(NotImplementedError, match="bf16.*HifiGanModel"):
        hifigan_torch.run(cfg)


def test_too_small_corpus_is_diagnosed(corpus, tmp_path):
    cfg = _train_cfg(corpus[0], tmp_path, "model.train_ds.dataloader_params.batch_size=64")
    with pytest.raises(ValueError, match="0 batches"):
        hifigan_torch.run(cfg)


def test_checkpoint_keeps_the_hifigan_layout(trained):
    """`GANTrainState` saves the task's `state_modules()` by name: for
    HiFi-GAN the keys a checkpoint has always had, so older checkpoints load."""
    _, state, root = trained
    saved = torch.load(root / "checkpoints" / "step_2.pt", weights_only=False)["state"]
    assert set(saved) == {"step", "generator", "mpd", "msd", "g_opt", "d_opt"}
    for name, module in state.model.state_modules().items():
        assert set(saved[name]) == set(module.state_dict()), name


def test_early_stopping_stops_train_gan_after_the_second_validation(corpus, tmp_path):
    """`create_early_stopping_callback` in the GAN runner, as roar_tpu's
    `train_gan` feeds it: an unreachable `min_delta` and patience 0 stop the
    run after the second validation round of six epochs."""
    import signal

    before = signal.getsignal(signal.SIGTERM)
    cfg = _train_cfg(corpus[0], tmp_path, "trainer.max_steps=1000", "trainer.max_epochs=6",
                     "exp_manager.create_tensorboard_logger=false",
                     "+exp_manager.create_early_stopping_callback=true",
                     "+exp_manager.early_stopping_callback_params.monitor=val_g_mel_loss",
                     "+exp_manager.early_stopping_callback_params.min_delta=1e9",
                     "+exp_manager.early_stopping_callback_params.patience=0")
    state = hifigan_torch.run(cfg)
    records = [json.loads(line) for line in
               (tmp_path / "HifiGan" / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if "val_g_mel_loss" in r]
    steps_per_epoch = val[0]["step"]
    assert len(val) == 2 and state.step == 2 * steps_per_epoch
    assert signal.getsignal(signal.SIGTERM) == before
