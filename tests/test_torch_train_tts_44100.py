"""The shipped TTS configurations chip_smoke.py runs besides the 22.05 kHz v1
pair: configs/fastpitch_44100_align.yaml, configs/hifigan_44100.yaml with the
v1_44100 generator, and the v2 and v3 generators under hifigan_22050.yaml.
The configs the script builds held to the YAMLs, and its phases rehearsed on
the CPU at rehearsal widths with the kernels' plain versions: every check but
the launch counts and the timings."""

import json
import sys
from pathlib import Path

import torch
import yaml

from roar_tpu_torch.config.config import load_config

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _assert_subdict(small, big, path=""):
    for key, value in small.items():
        assert key in big, f"{path}{key} not in the YAML"
        if isinstance(value, dict):
            _assert_subdict(value, big[key], f"{path}{key}.")
        else:
            assert value == big[key], f"{path}{key}: {value!r} != {big[key]!r}"


def _lines(capsys, phase):
    return [line for line in (json.loads(text) for text in capsys.readouterr().out.splitlines()
                              if text.startswith("{")) if line.get("phase") == phase]


def test_configs_match_the_44100_and_generator_yamls():
    data = ["train_dataset=m.json", "validation_datasets=m.json"]
    hg44 = load_config(REPO / "configs" / "hifigan_44100.yaml", overrides=data + [
        "trainer.max_steps=4", "trainer.log_every_n_steps=1", "+trainer.max_epochs=2",
        "exp_manager.exp_dir=e", "+exp_manager.always_save_roar=true", "+device=cuda"])
    got = chip_smoke.hifigan_train_config("m.json", "e", max_steps=4, sample_rate=44100,
                                          generator="v1_44100")
    _assert_subdict(got, hg44)
    assert got["model"]["generator"]["upsample_rates"] == [8, 8, 4, 2]
    for name in ("v1", "v1_44100", "v2", "v3"):
        yaml_cfg = yaml.safe_load((REPO / "configs" / "hifigan" / "generator"
                                   / f"{name}.yaml").read_text())
        assert yaml_cfg.pop("_target_").endswith("hifigan.Generator")
        assert chip_smoke.hifigan_config(generator=name)["generator"] == yaml_cfg, name
    fp44 = load_config(REPO / "configs" / "fastpitch_44100_align.yaml", overrides=[
        "train_dataset=t.json", "validation_datasets=v.json", "sup_data_path=s",
        "pitch_mean=201.5", "pitch_std=55.25"])
    got = chip_smoke.fastpitch_train_config("t.json", "v.json", "s", "e", 201.5, 55.25,
                                            precision="bf16", sample_rate=44100)
    assert got["model"]["preprocessor"]["sample_rate"] == fp44["sample_rate"] == 44100
    assert got["model"]["train_ds"]["dataset"]["sample_rate"] == 44100
    assert (fp44["n_fft"], fp44["n_window_size"], fp44["n_window_stride"]) == (2048, 2048, 512)
    assert got["trainer"]["precision"] == fp44["trainer"]["precision"] == "bf16"
    sup = chip_smoke.sup_data_config("m.json", "sup", sample_rate=44100)["dataset"]
    assert (sup["sample_rate"], sup["n_fft"], sup["win_length"], sup["hop_length"]) == \
        (44100, 2048, 2048, 512)


def test_fastpitch_44100_phase_rehearsal(capsys):
    """Sup-data at 44.1 kHz, bf16 training, the bundle served by the v1_44100
    vocoder (hop 512), and one text bucket served without warm-up."""
    out = chip_smoke.phase_train_fastpitch(
        torch.device("cpu"), n_utterances=4, steps=4, batch_size=2, max_seconds=1.5,
        narrow=True, precision="bf16", sample_rate=44100, serve=True)
    none = {"fwd": 0, "dkv": 0, "dq": 0}
    assert out["launches"] == out["launches_bf16"] == none
    assert out["sup_launches"] == {"fwd": 0, "backtrack": 0}
    steps = {line["step"]: line for line in _lines(capsys, "train_fastpitch_44100")}
    assert set(steps) == {"cli", "kernel_path_vs_plain_path", "serve", "bundle"}
    assert steps["cli"]["sample_rate"] == 44100 and steps["cli"]["precision"] == "bf16"
    assert steps["bundle"]["vocoder_hop"] == 512 and steps["bundle"]["sample_rate"] == 44100
    serve = steps["serve"]
    assert serve["warmup"] is False and serve["hop"] == 512
    assert set(serve) >= {"batch_8", "batch_1"} and serve["batch_8"]["audio_s"] > 0


def test_hifigan_44100_v2_v3_phase_rehearsals(capsys):
    for kw, phase, hop in ((dict(sample_rate=44100, generator="v1_44100"),
                            "train_hifigan_44100", 512),
                           (dict(generator="v2", timed=False), "train_hifigan_v2", 256),
                           (dict(generator="v3", timed=False), "train_hifigan_v3", 256)):
        out = chip_smoke.phase_train_hifigan(torch.device("cpu"), n_utterances=4, steps=2,
                                             batch_size=2, n_segments=2048, debug=True, **kw)
        assert out == {"launches": {"fwd": 0, "dx": 0, "dw": 0}}
        lines = _lines(capsys, phase)
        assert [r["step"] for r in lines] == ["cli", "bundle", "kernel_path_vs_plain_path"]
        assert lines[1]["audio_shape"] == [1, 64 * hop]
        assert lines[0]["generator"] == kw["generator"]
