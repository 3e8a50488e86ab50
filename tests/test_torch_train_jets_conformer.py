"""The JETS-Conformer training run of the port on the CPU:
configs/jets_22050_conformer.yaml through the port's config loader and one
narrow step of `examples/tts/jets_torch.py`, chip_smoke.py's Conformer
config held to the YAML, and its phase `train_jets_conformer` rehearsed at
debug widths with the plain versions.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_train_jets import NARROW
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu_torch.config.config import load_config
from roar_tpu_torch.data.audio import write_wav
from roar_tpu_torch.data.manifest import write_manifest
from roar_tpu_torch.models.conformer import FFConformerDecoder, FFConformerEncoder

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "examples" / "tts"))
sys.path.insert(0, str(REPO / "scripts" / "dataset_processing" / "tts"))
import chip_smoke  # noqa: E402
import extract_sup_data_torch  # noqa: E402  (the port's extraction CLI module)
import jets_torch  # noqa: E402  (the port's CLI module)

YAML = REPO / "configs" / "jets_22050_conformer.yaml"
FLASH_ON = ["model.input_fft.use_flash=true", "model.output_fft.use_flash=true"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four seeded utterances of 1 to 1.5 s with Bengali text and two
    speakers, their sup-data extracted at hop 256."""
    root = tmp_path_factory.mktemp("jets_conformer_corpus")
    rng = np.random.default_rng(1)
    entries = []
    for i in range(4):
        audio = chip_smoke.synth_utterance(rng, float(rng.uniform(1.0, 1.5)))[0]
        path = str(root / f"utt{i}.wav")
        write_wav(path, audio, 22050)
        entries.append({"audio_filepath": path, "duration": len(audio) / 22050,
                        "text": chip_smoke.BENGALI_SENTENCES[(0, 1, 3, 5)[i]],
                        "speaker_id": i % 2})
    manifest = str(root / "manifest.json")
    write_manifest(manifest, entries)
    sup = str(root / "sup")
    stats = extract_sup_data_torch.run(chip_smoke.jets_sup_data_config(manifest, sup, "cpu"))
    return manifest, sup, stats


def test_conformer_yaml_loads_and_trains_one_narrow_step(corpus, tmp_path):
    manifest, sup, stats = corpus
    cfg = load_config(YAML, overrides=[
        f"train_dataset={manifest}", f"validation_datasets={manifest}", f"sup_data_path={sup}",
        f"pitch_mean={stats['pitch_mean']}", f"pitch_std={stats['pitch_std']}",
        "model.speaker_encoder.lookup_module.n_speakers=2", *FLASH_ON,
        "model.train_ds.dataloader_params.batch_size=2",
        "model.train_ds.dataloader_params.num_workers=0",
        "model.validation_ds.dataloader_params.batch_size=2",
        "model.validation_ds.dataloader_params.num_workers=0",
        "trainer.max_steps=1", "trainer.log_every_n_steps=1", f"exp_manager.exp_dir={tmp_path}",
        "+device=cpu", *NARROW])
    model_cfg = cfg["model"]
    # the YAML's own: Conformer stacks of two heads with RoPE, kernel 31, bf16-mixed
    assert cfg["name"] == "JETS-Conformer" and cfg["trainer"]["precision"] == "bf16-mixed"
    for fft in ("input_fft", "output_fft"):
        block = model_cfg[fft]
        assert (block["encoder_type"], block["n_head"], block["kernel_size"], block["use_rope"],
                block["use_flash"], block["dropatt"]) == ("conformer", 2, 31, True, True, 0.1)
    state = jets_torch.run(cfg)
    module = state.model.module
    assert isinstance(module.encoder_module, FFConformerEncoder)
    assert isinstance(module.decoder_module, FFConformerDecoder)
    assert state.step == 1 and state.model.compute_dtype == torch.bfloat16
    assert state.model.attention_paths() == {"input_fft": "einsum", "output_fft": "einsum"}
    records = [json.loads(line) for line in
               (tmp_path / "JETS-Conformer" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "d_loss" in r]
    assert [r["step"] for r in steps] == [1]
    assert all(np.isfinite(steps[0][k]) for k in chip_smoke.JETS_LOSS_TERMS), steps[0]
    val = [r for r in records if "val_g_mel_loss" in r]
    assert val and all(np.isfinite(val[0][f"val_{k}"]) for k in chip_smoke.JETS_G_TERMS)


def _assert_subdict(small, big, path=""):
    for key, value in small.items():
        assert key in big, f"{path}{key} not in the YAML"
        if isinstance(value, dict):
            _assert_subdict(value, big[key], f"{path}{key}.")
        else:
            assert value == big[key], f"{path}{key}: {value!r} != {big[key]!r}"


def test_chip_smoke_conformer_config_matches_the_yaml():
    yaml_cfg = load_config(YAML, overrides=[
        "train_dataset=t.json", "validation_datasets=v.json", "sup_data_path=s",
        "pitch_mean=200.0", "pitch_std=50.0", *FLASH_ON,
        "model.speaker_encoder.lookup_module.n_speakers=4", "trainer.max_steps=4",
        "trainer.log_every_n_steps=1", "exp_manager.exp_dir=e",
        "+exp_manager.always_save_roar=true", "+device=cuda"])
    cfg = chip_smoke.jets_train_config("t.json", "v.json", "s", "e", 200.0, 50.0, max_steps=4,
                                       precision="bf16-mixed", conformer=True)
    _assert_subdict(cfg, yaml_cfg)
    model = cfg["model"]
    # full width and depth: 6 + 6 Conformer layers, d 384, two heads of 64
    assert model["symbols_embedding_dim"] == 384 and model["segment_size"] == 64
    for fft in ("input_fft", "output_fft"):
        assert (model[fft]["n_layer"], model[fft]["n_head"], model[fft]["d_head"],
                model[fft]["d_inner"]) == (6, 2, 64, 1536)
    assert model["train_ds"]["dataloader_params"]["batch_size"] == 16


def test_chip_smoke_conformer_phase_rehearsal_on_the_cpu(capsys):
    """The card's JETS-Conformer phase at debug widths with the plain
    versions: every check of the phase but the launch counts and timings."""
    out = chip_smoke.phase_train_jets(torch.device("cpu"), n_utterances=6, n_val=2, steps=4,
                                      batch_size=2, max_seconds=1.5, narrow=True,
                                      precision="bf16-mixed", conformer=True)
    assert out["launches"] == out["launches_bf16"] == dict.fromkeys(
        ("fwd", "dkv", "dq", "grouped_conv_fwd", "grouped_conv_dx", "grouped_conv_dw"), 0)
    assert out["synthesis"]["batch_8"]["samples_per_frame"] == 256
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    steps = [r for r in lines if r.get("phase") == "train_jets_conformer"]
    assert [r["step"] for r in steps] == ["cli", "bundle_synthesis", "kernel_path_vs_plain_path",
                                          "wall"]
    assert steps[0]["attention_paths"] == {"training": "einsum", "eval": "flash"}
