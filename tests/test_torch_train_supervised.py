"""The FastPitch training run of the port, end to end on the CPU: sup-data
extraction (stage 1) feeds the training CLI's `run` (stage 2) on four tiny
WAVs at a narrow width, with checkpoints, validation, resume and the
end-of-training `.roar`; the bundle is read back by the JAX package's
`restore_from` and applied by its `FastPitchModel`, and it is served by the
port's `SynthesisEngine`.
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

from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel
from roar_tpu.training.save_restore import restore_from as jax_restore_from
from roar_tpu_torch.config.config import load_config
from roar_tpu_torch.data.audio import write_wav
from roar_tpu_torch.data.manifest import write_manifest
from roar_tpu_torch.models.fastpitch_model import FastPitchModel
from roar_tpu_torch.models.hifigan_model import generator_from_config
from roar_tpu_torch.serving import SynthesisEngine
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.optim import noam_annealing
from roar_tpu_torch.training.save_restore import restore_from

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples" / "tts"))
sys.path.insert(0, str(REPO / "scripts" / "dataset_processing" / "tts"))
import extract_sup_data_torch  # noqa: E402  (the port's stage-1 script)
import fastpitch_torch  # noqa: E402  (the port's CLI module)

SR = 22050
TEXTS = ["வணக்கம்", "நன்றி நண்பா", "தமிழ் மொழி", "இன்று நல்ல நாள்"]
# port vs JAX applying the same bundle, fp32 (the bar of tests/test_torch_fastpitch.py)
FWD_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four vibrato tones of 0.5 to 0.9 s with Tamil text and two speakers,
    and their sup-data extracted by the port's script on the CPU."""
    root = tmp_path_factory.mktemp("fp_corpus")
    rng = np.random.default_rng(0)
    entries = []
    for i, text in enumerate(TEXTS):
        n = int(SR * (0.5 + 0.13 * i))
        t = np.arange(n) / SR
        f0 = 120.0 * (i + 1) * 2.0 ** (30.0 * np.sin(2 * np.pi * 5 * t) / 1200.0)
        audio = (0.3 * np.sin(2 * np.pi * np.cumsum(f0) / SR)
                 + 0.005 * rng.standard_normal(n)).astype(np.float32)
        path = root / "wavs" / f"utt{i}.wav"
        path.parent.mkdir(exist_ok=True)
        write_wav(str(path), audio, SR)
        entries.append({"audio_filepath": str(path), "text": text, "duration": n / SR,
                        "speaker_id": i % 2})
    manifest = str(root / "train_manifest.json")
    write_manifest(manifest, entries)
    sup = str(root / "sup")
    stats = extract_sup_data_torch.run(load_config(
        REPO / "configs" / "ds_for_fastpitch_align.yaml",
        overrides=[f"manifest_filepath={manifest}", f"sup_data_path={sup}", "+device=cpu",
                   "+batch_size=4"]))
    return manifest, sup, stats


def _train_cfg(corpus, exp_dir, *extra):
    manifest, sup, stats = corpus
    narrow = []
    for fft in ("input_fft", "output_fft"):
        narrow += [f"model.{fft}.n_layer=1", f"model.{fft}.d_head=16", f"model.{fft}.n_head=2",
                   f"model.{fft}.d_inner=48", f"+model.{fft}.use_flash=true",
                   f"model.{fft}.dropatt=0.0"]
    for pred in ("duration_predictor", "pitch_predictor"):
        narrow.append(f"model.{pred}.filter_size=16")
    return load_config(REPO / "configs" / "fastpitch_22050_align.yaml", overrides=[
        f"train_dataset={manifest}", f"validation_datasets={manifest}", f"sup_data_path={sup}",
        f"pitch_mean={stats['pitch_mean']}", f"pitch_std={stats['pitch_std']}",
        "model.symbols_embedding_dim=32", *narrow,
        "model.speaker_encoder.lookup_module.n_speakers=2",
        "model.train_ds.dataloader_params.batch_size=2",
        "model.train_ds.dataloader_params.num_workers=0",
        "model.validation_ds.dataloader_params.num_workers=0",
        "model.optim.sched.warmup_steps=3", "trainer.precision=32", "trainer.max_epochs=4",
        "trainer.max_steps=3", "trainer.log_every_n_steps=1",
        f"exp_manager.exp_dir={exp_dir}", "+exp_manager.always_save_roar=true", "+device=cpu",
        *extra])


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    exp_dir = tmp_path_factory.mktemp("exp")
    cfg = _train_cfg(corpus, exp_dir)
    state = fastpitch_torch.run(cfg)
    return cfg, state, Path(exp_dir) / "FastPitch"


def test_three_steps_log_validate_and_checkpoint(trained):
    cfg, state, root = trained
    assert state.step == 3 and state.opt.count == 3
    assert (root / "checkpoints" / "step_3.pt").exists()
    assert (root / "checkpoints" / "FastPitch.roar").exists()
    records = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "mel_loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    for r in steps:
        assert all(np.isfinite(r[k]) for k in ("loss", "mel_loss", "dur_loss", "pitch_loss",
                                               "ctc_loss", "bin_loss", "grad_norm"))
    assert steps[0]["bin_loss"] == 0.0  # epoch 0 of the warm-up
    assert steps[2]["bin_loss"] > 0.0  # epoch 1: weight 1/100
    schedule = noam_annealing(1e-3, d_model=1, warmup_steps=3)
    np.testing.assert_allclose([r["lr"] for r in steps], [schedule(i) for i in range(3)],
                               rtol=1e-9)
    # two steps make an epoch: validation ran after the first, not after the stop
    val = [r for r in records if "val_mel_loss" in r]
    assert len(val) == 1 and val[0]["step"] == 2 and np.isfinite(val[0]["val_loss"])
    assert state.model.module.training
    assert state.model.attention_paths() == {"input_fft": "flash", "output_fft": "flash"}


def test_resume_continues_from_the_checkpoint(trained, corpus, tmp_path):
    cfg, state, root = trained
    shutil.copytree(root.parent, tmp_path / "exp")
    again = _train_cfg(corpus, tmp_path / "exp", "exp_manager.resume_if_exists=true",
                       "trainer.max_steps=5")
    resumed = fastpitch_torch.run(again)
    assert resumed.step == 5 and resumed.opt.count == 5
    assert (tmp_path / "exp" / "FastPitch" / "checkpoints" / "step_5.pt").exists()
    adam = resumed.opt.optimizer.state_dict()["state"]
    assert all(int(s["step"]) == 5 for s in adam.values())
    records = [json.loads(line) for line in
               (tmp_path / "exp" / "FastPitch" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "mel_loss" in r] == [1, 2, 3, 4, 5]


def test_bundle_is_read_by_the_jax_package_and_served_by_the_port(trained):
    cfg, state, root = trained
    path = str(root / "checkpoints" / "FastPitch.roar")
    want = convert.fastpitch_to_jax_tree(state.model.module)

    jcfg, jtree = jax_restore_from(path)
    assert jcfg["trainer"]["max_steps"] == 3 and jcfg["model"]["optim"]["lr"] == 0.001
    got_flat, want_flat = flatten_dict(jtree), flatten_dict(want)
    assert set(got_flat) == set(want_flat)
    for key, value in want_flat.items():
        assert got_flat[key].shape == value.shape and got_flat[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got_flat[key], value, err_msg=str(key))

    # the JAX task applies the tree; the port reads its own bundle back
    jmodel = JaxFastPitchModel(jcfg["model"])
    tokens = jmodel.parse(TEXTS[1])
    tokens = np.pad(tokens, ((0, 0), (0, 16 - tokens.shape[1])),
                    constant_values=jmodel.tokenizer.pad)
    speaker = np.array([1], np.int32)
    jmel, jlens = jmodel.generate_spectrogram(jtree, jnp.asarray(tokens), jnp.asarray(speaker),
                                              max_mel_len=128)
    pcfg, ptree = restore_from(path)
    assert pcfg == jcfg
    fp = FastPitchModel(pcfg["model"])
    convert.load_fastpitch_params(fp.module, ptree)
    mel, lens = fp.generate_spectrogram(torch.from_numpy(tokens).long(),
                                        torch.from_numpy(speaker).long(), max_mel_len=128)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), **FWD_TOL)

    gen = generator_from_config({"resblock": 2, "upsample_rates": [8, 8, 4],
                                 "upsample_kernel_sizes": [16, 16, 8],
                                 "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                                 "resblock_dilation_sizes": [[1, 3]]}, 80)
    engine = SynthesisEngine(fp, gen, device="cpu", text_buckets=(16,), batch_buckets=(1,),
                             frames_per_token=8)
    try:
        (wave,) = engine.synthesize_batch([TEXTS[1]], [1])
    finally:
        engine.close()
    assert wave.dtype == np.int16 and wave.size == int(lens[0]) * 256


def test_bf16_and_model_parallel_raise(corpus, tmp_path, monkeypatch):
    # bf16 trains FastPitch (tests/test_torch_bf16_tts.py); the trainer still
    # refuses it, by the task's name, for a task without `set_compute_dtype`
    from roar_tpu_torch.models.fastpitch_model import FastPitchModel

    with monkeypatch.context() as patch:
        patch.delattr(FastPitchModel, "set_compute_dtype")
        with pytest.raises(NotImplementedError, match="bf16.*FastPitchModel"):
            fastpitch_torch.run(_train_cfg(corpus, tmp_path, "trainer.precision=bf16"))
    with pytest.raises(NotImplementedError, match="model_parallel_size"):
        fastpitch_torch.run(_train_cfg(corpus, tmp_path, "trainer.model_parallel_size=2"))


def _assert_subdict(small, big, path=""):
    for key, value in small.items():
        assert key in big, f"{path}{key} not in the YAML"
        if isinstance(value, dict):
            _assert_subdict(value, big[key], f"{path}{key}.")
        else:
            assert value == big[key], f"{path}{key}: {value!r} != {big[key]!r}"


def test_chip_smoke_training_config_matches_yaml():
    """The config `chip_smoke.py` trains at is the YAML under the overrides
    its docstring names: flash on, `dropatt` 0, 4 speakers, an energy
    predictor, fp32."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    predictor = ("{input_size: 384, kernel_size: 3, filter_size: 256, dropout: 0.1, n_layers: 2, "
                 "condition_types: [add, layernorm]}")
    overrides = ["train_dataset=t.json", "validation_datasets=v.json", "sup_data_path=s",
                 "pitch_mean=201.5", "pitch_std=55.25",
                 "sup_data_types=[align_prior_matrix,pitch,speaker_id,energy]",
                 "model.speaker_encoder.lookup_module.n_speakers=4",
                 f"+model.energy_predictor={predictor}", "trainer.precision=32",
                 "+trainer.max_steps=8", "trainer.log_every_n_steps=1", "exp_manager.exp_dir=e",
                 "+exp_manager.always_save_roar=true", "+device=cuda"]
    for fft in ("input_fft", "output_fft"):
        overrides += [f"+model.{fft}.use_flash=true", f"model.{fft}.dropatt=0.0"]
    yaml_cfg = load_config(REPO / "configs" / "fastpitch_22050_align.yaml", overrides=overrides)
    got = chip_smoke.fastpitch_train_config("t.json", "v.json", "s", "e", 201.5, 55.25)
    got["model"]["validation_ds"]["dataset"]["manifest_filepath"] = "v.json"
    _assert_subdict(got, yaml_cfg)
    assert got["model"]["train_ds"]["dataloader_params"]["batch_size"] == 32
    model = FastPitchModel(got["model"])
    assert model.module.energy_predictor_module is not None and model.module.learn_alignment
    assert len(model.module.decoder_module.layers) == 6 and model.mel_cfg.n_fft == 2048


def test_chip_smoke_training_phase_rehearsal_on_the_cpu(capsys):
    """`phase_train_fastpitch` end to end at a rehearsal width on the CPU:
    every check of the phase but the launch counts and the timing."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    out = chip_smoke.phase_train_fastpitch(torch.device("cpu"), n_utterances=4, steps=4,
                                           batch_size=2, max_seconds=1.5, narrow=True)
    assert out == {"launches": {"fwd": 0, "dkv": 0, "dq": 0}}  # no kernel on the CPU
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    steps = {line["step"]: line for line in lines if line.get("phase") == "train_fastpitch"}
    assert set(steps) == {"cli", "kernel_path_vs_plain_path", "bundle"}
    assert steps["cli"]["validation_batches"] == 1 and steps["cli"]["attention_layers"] == 4
    assert steps["kernel_path_vs_plain_path"]["max_grad_l2_rel_err"] == 0.0
