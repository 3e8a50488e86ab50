"""The JETS training run of the port: CLI, checkpoint and resume, bundle,
and chip_smoke.py's JETS phase.

`examples/tts/jets_torch.py` trains two steps on the CPU at narrow widths
(configs/jets_22050_align.yaml with overrides) on a tiny Bengali corpus whose
sup-data the port's extraction CLI wrote at the model's hop; a checkpoint
restores the whole `JETSModule`, its discriminators, optimizers and random
generator; the `.roar` bundle is read by the JAX package's `JETSModel`, which
synthesises what the port synthesises.  Then chip_smoke.py's JETS configs are
held to the YAMLs, its discriminator shapes at 16384 samples are checked, and
its phase `train_jets` is rehearsed at debug widths with the plain versions.
"""

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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu.config import load_config
from roar_tpu.models.jets_model import JETSModel as JaxJETSModel
from roar_tpu.training.save_restore import restore_from as jax_restore_from
from roar_tpu_torch.data.audio import write_wav
from roar_tpu_torch.data.manifest import write_manifest
from roar_tpu_torch.models.jets_model import JETSModel
from roar_tpu_torch.training.gan import GANTrainState
from roar_tpu_torch.training.optim import build_optimizer

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "examples" / "tts"))
sys.path.insert(0, str(REPO / "scripts" / "dataset_processing" / "tts"))
import chip_smoke  # noqa: E402
import extract_sup_data_torch  # noqa: E402  (the port's extraction CLI module)
import jets_torch  # noqa: E402  (the port's CLI module)

SR = 22050
FWD_TOL = dict(atol=2e-4, rtol=1e-3)  # the bar of tests/test_torch_jets.py
NARROW = [
    "model.symbols_embedding_dim=32", "model.segment_size=8", "+model.debug=true",
    "model.input_fft.n_layer=1", "model.input_fft.d_head=16", "model.input_fft.d_inner=64",
    "model.output_fft.n_layer=1", "model.output_fft.d_head=16", "model.output_fft.d_inner=64",
    "model.duration_predictor.filter_size=16", "model.pitch_predictor.filter_size=16",
    "model.energy_predictor.filter_size=16",
    "model.waveform_generator.upsample_initial_channel=32",
    "model.waveform_generator.resblock_kernel_sizes=[3]",
    "model.waveform_generator.resblock_dilation_sizes=[[1,3]]",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six seeded utterances of 1 to 1.5 s with Bengali text and two
    speakers, their sup-data extracted at hop 256."""
    root = tmp_path_factory.mktemp("jets_corpus")
    rng = np.random.default_rng(0)
    entries = []
    for i in range(6):
        audio = chip_smoke.synth_utterance(rng, float(rng.uniform(1.0, 1.5)))[0]
        path = str(root / f"utt{i}.wav")
        write_wav(path, audio, SR)
        entries.append({"audio_filepath": path, "duration": len(audio) / SR,
                        "text": chip_smoke.BENGALI_SENTENCES[(0, 1, 3, 5)[i % 4]],
                        "speaker_id": i % 2})
    manifest = str(root / "train_manifest.json")
    write_manifest(manifest, entries)
    sup = str(root / "sup")
    stats = extract_sup_data_torch.run(chip_smoke.jets_sup_data_config(manifest, sup, "cpu"))
    return manifest, sup, stats


def _train_cfg(corpus, exp_dir, *extra):
    manifest, sup, stats = corpus
    return load_config(REPO / "configs" / "jets_22050_align.yaml", overrides=[
        f"train_dataset={manifest}", f"validation_datasets={manifest}", f"sup_data_path={sup}",
        f"pitch_mean={stats['pitch_mean']}", f"pitch_std={stats['pitch_std']}",
        "model.speaker_encoder.lookup_module.n_speakers=2", "trainer.precision=32",
        "model.train_ds.dataloader_params.batch_size=2",
        "model.train_ds.dataloader_params.num_workers=0",
        "model.validation_ds.dataloader_params.batch_size=2",
        "model.validation_ds.dataloader_params.num_workers=0",
        "trainer.max_steps=2", "trainer.log_every_n_steps=1", f"exp_manager.exp_dir={exp_dir}",
        "+exp_manager.always_save_roar=true", "+device=cpu", *NARROW, *extra])


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    exp_dir = tmp_path_factory.mktemp("jets_exp")
    cfg = _train_cfg(corpus, exp_dir)
    state = jets_torch.run(cfg)
    return cfg, state, Path(exp_dir) / "JETS"


def test_cli_trains_two_steps_and_logs(trained):
    cfg, state, root = trained
    assert state.step == 2 and state.g_opt.count == 2 and state.d_opt.count == 2
    assert (root / "checkpoints" / "step_2.pt").exists()
    records = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "d_loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert all(np.isfinite(r[k]) for k in chip_smoke.JETS_LOSS_TERMS), r
        assert r["bin_loss"] == 0.0  # epoch 0 of the warm-up
    # CosineAnnealing, warmup_ratio 0.02 of model.max_steps 2.5M
    np.testing.assert_allclose([r["lr"] for r in steps], [2e-4 * 1 / 50001, 2e-4 * 2 / 50001],
                               rtol=1e-9)
    assert any("val_g_mel_loss" in r for r in records)


def test_checkpoint_restores_the_whole_module_and_resume_continues(trained, corpus, tmp_path):
    cfg, state, root = trained
    saved = torch.load(root / "checkpoints" / "step_2.pt", weights_only=False)["state"]
    assert set(saved) == {"step", "module", "mpd", "msd", "g_opt", "d_opt", "rng"}
    fresh = JETSModel(cfg["model"])
    restored = GANTrainState(
        model=fresh, g_opt=build_optimizer(fresh.g_parameters(), cfg["model"]["optim"],
                                           max_steps=10),
        d_opt=build_optimizer(fresh.d_parameters(), cfg["model"]["optim"], max_steps=10),
        generator=torch.Generator())
    restored.load_state_dict(saved)
    assert restored.step == 2 and restored.g_opt.count == 2
    for part, module in state.model.state_modules().items():
        for (name, a), (_, b) in zip(fresh.state_modules()[part].state_dict().items(),
                                     module.state_dict().items()):
            assert torch.equal(a, b), f"{part}.{name}"
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())

    shutil.copytree(root.parent, tmp_path / "exp")
    resumed = jets_torch.run(_train_cfg(corpus, tmp_path / "exp",
                                        "exp_manager.resume_if_exists=true", "trainer.max_steps=3"))
    assert resumed.step == 3 and resumed.g_opt.count == 3
    assert (tmp_path / "exp" / "JETS" / "checkpoints" / "step_3.pt").exists()


def test_bundle_is_read_by_the_jax_package(trained):
    cfg, state, root = trained
    path = str(root / "checkpoints" / "JETS.roar")
    jcfg, jtree = jax_restore_from(path)
    assert jcfg["trainer"]["max_steps"] == 2 and jcfg["model"]["segment_size"] == 8
    want = state.model.to_jax_tree()
    got_flat, want_flat = flatten_dict(jtree), flatten_dict(want)
    assert set(got_flat) == set(want_flat)
    for key, value in want_flat.items():
        np.testing.assert_array_equal(got_flat[key], value, err_msg=str(key))

    # the JAX task applies the tree: synthesis and its discriminators
    jmodel = JaxJETSModel(jcfg["model"])
    tokens = np.asarray(state.model.parse(chip_smoke.BENGALI_SENTENCES[1]))
    speaker = np.array([1], np.int32)
    out = jax.jit(lambda g: jmodel.module.apply(
        g, jnp.asarray(tokens), speaker=jnp.asarray(speaker), max_mel_len=32,
        method=jmodel.module.infer))(jtree["g_params"])
    audio = jnp.zeros((2, 8 * 256))
    jmodel.msd.apply({"params": jtree["d_params"]["params"]["msd"],
                      "batch_stats": jtree["d_stats"]["msd"]}, audio, audio)
    jmodel.mpd.apply({"params": jtree["d_params"]["params"]["mpd"]}, audio, audio)
    wav, frames = state.model.convert_text_to_waveform(
        torch.from_numpy(tokens).long(), torch.from_numpy(speaker).long(), max_mel_len=32)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(out["num_frames"]))
    np.testing.assert_allclose(wav.numpy(), np.asarray(out["wav"]), **FWD_TOL)


def _assert_subdict(small, big, path=""):
    for key, value in small.items():
        assert key in big, f"{path}{key} not in the YAML"
        if isinstance(value, dict):
            _assert_subdict(value, big[key], f"{path}{key}.")
        else:
            assert value == big[key], f"{path}{key}: {value!r} != {big[key]!r}"


def test_chip_smoke_jets_configs_match_the_yamls():
    yaml_cfg = load_config(REPO / "configs" / "jets_22050_align.yaml", overrides=[
        "train_dataset=t.json", "validation_datasets=v.json", "sup_data_path=s",
        "pitch_mean=200.0", "pitch_std=50.0", "+model.input_fft.use_flash=true",
        "+model.output_fft.use_flash=true", "model.input_fft.dropatt=0.0",
        "model.output_fft.dropatt=0.0", "model.speaker_encoder.lookup_module.n_speakers=4",
        "trainer.precision=32", "trainer.max_steps=8", "trainer.log_every_n_steps=1",
        "exp_manager.exp_dir=e", "+exp_manager.always_save_roar=true", "+device=cuda"])
    cfg = chip_smoke.jets_train_config("t.json", "v.json", "s", "e", 200.0, 50.0)
    _assert_subdict(cfg, yaml_cfg)
    model = cfg["model"]
    # full width and depth, every dropout but attention's at the YAML's 0.1
    assert model["symbols_embedding_dim"] == 384 and model["segment_size"] == 64
    for fft in ("input_fft", "output_fft"):
        assert model[fft]["n_layer"] == 6 and model[fft]["dropout"] == 0.1
    assert model["waveform_generator"]["upsample_initial_channel"] == 512
    assert "debug" not in model and model.get("msd_variant", "grouped") == "grouped"
    assert model["train_ds"]["dataloader_params"]["batch_size"] == 16

    ds_yaml = load_config(REPO / "configs" / "ds_for_jets_ben_align.yaml", overrides=[
        "manifest_filepath=m.json", "sup_data_path=s"])
    sup = chip_smoke.jets_sup_data_config("m.json", "s", "cuda")
    stft = {"n_fft": 1024, "win_length": 1024, "hop_length": 256}  # the model's, not the YAML's
    assert {k: sup["dataset"][k] for k in stft} == stft
    assert {k: ds_yaml["dataset"][k] for k in stft} == {"n_fft": 2048, "win_length": 2048,
                                                        "hop_length": 512}
    _assert_subdict({k: v for k, v in sup["dataset"].items() if k not in stft},
                    ds_yaml["dataset"])
    assert sup["batch_size"] == ds_yaml["batch_size"]
    assert sup["audio_pad_multiple"] == ds_yaml["audio_pad_multiple"]
    assert {k: stft[k] for k in ("n_fft", "hop_length")} == {
        "n_fft": yaml_cfg["model"]["n_fft"], "hop_length": yaml_cfg["model"]["n_window_stride"]}


def test_msd_grouped_shapes_at_16384_samples():
    shapes = chip_smoke.msd_grouped_shapes(32, 16384)
    assert len(shapes) == 15 and shapes[0] == (32, 16384, 128, 128, 41, 2, 4, 20)
    assert [s[1] for s in shapes[:5]] == [16384, 8192, 4096, 1024, 256]
    assert [s[1] for s in shapes[5:10]] == [8193, 4097, 2049, 513, 129]
    assert [s[1] for s in shapes[10:]] == [4097, 2049, 1025, 257, 65]


def test_chip_smoke_jets_phase_rehearsal_on_the_cpu(capsys):
    """The card's JETS phase at debug widths with the plain versions: every
    check of the phase but the launch counts and the timings."""
    out = chip_smoke.phase_train_jets(torch.device("cpu"), n_utterances=6, n_val=2, steps=4,
                                      batch_size=2, max_seconds=1.5, narrow=True)
    assert out["launches"] == dict.fromkeys(("fwd", "dkv", "dq", "grouped_conv_fwd",
                                             "grouped_conv_dx", "grouped_conv_dw"), 0)
    assert out["synthesis"]["batch_8"]["samples_per_frame"] == 256
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [r["step"] for r in lines if r.get("phase") == "train_jets"] == [
        "cli", "bundle_synthesis", "kernel_path_vs_plain_path", "wall"]
