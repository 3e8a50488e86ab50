"""The training runner's engine parts on the CPU: `run_test` against the JAX
package's on one tiny corpus and one set of weights, early stopping in
`train_supervised` (2 of 6 epochs, as tests/test_runner.py shows for JAX),
the profiler window's trace, the validation artifacts with the Griffin-Lim
preview, and the SIGTERM handler put back after a run and after a failed
one."""

import json
import signal
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from roar_tpu.data import BucketSpec as JaxBucketSpec
from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel
from roar_tpu.training.run import build_tts_dataset as jax_build_tts_dataset
from roar_tpu.training.run import run_test as jax_run_test
from roar_tpu_torch.data.audio import read_wav
from roar_tpu_torch.data.dataset import BucketSpec
from roar_tpu_torch.models.fastpitch_model import FastPitchModel
from roar_tpu_torch.training import run
from roar_tpu_torch.training.trainer import TrainState

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
sys.path.insert(0, str(TESTS.parent / "examples" / "tts"))
import fastpitch_torch  # noqa: E402
from test_torch_train_supervised import _train_cfg, corpus  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-3


def _quiet(cfg):
    cfg["exp_manager"]["create_tensorboard_logger"] = False
    return cfg


def _test_cfg(corpus, tmp_path, batch_size=3):
    cfg = _quiet(_train_cfg(corpus, tmp_path / "exp"))
    cfg["model"]["test_ds"] = {"dataloader_params": {"batch_size": batch_size}}
    return cfg


@pytest.fixture(scope="module")
def weights(corpus, tmp_path_factory):
    cfg = _test_cfg(corpus, tmp_path_factory.mktemp("w"))
    return FastPitchModel(cfg["model"], generator=torch.Generator().manual_seed(7)).to_jax_tree()


@pytest.mark.parametrize("epoch", [0, 50])
def test_run_test_matches_jax(corpus, weights, tmp_path, epoch):
    """Four utterances in batches of 3 (the last ragged, weighted by its
    size), at the start of the bin-loss warm-up and half-way through it."""
    cfg = _test_cfg(corpus, tmp_path)
    model = FastPitchModel(cfg["model"])
    from roar_tpu_torch.training import convert

    convert.load_fastpitch_params(model.module, weights)
    model.module.train()  # run_test evaluates in eval mode and puts the mode back
    ds_cfg = cfg["model"]["train_ds"]["dataset"]
    got = run.run_test(cfg, model, run.build_tts_dataset(ds_cfg, model.tokenizer, "cpu"),
                       buckets=BucketSpec(), log_dir=str(tmp_path / "t"), epoch=epoch,
                       device="cpu")
    jax_model = JaxFastPitchModel(cfg["model"])
    want = jax_run_test(cfg, jax_model, jax_build_tts_dataset(ds_cfg, jax_model.tokenizer),
                        params=jax.device_get(weights), buckets=JaxBucketSpec(), epoch=epoch)
    assert set(got) == set(want) and "test_loss" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
    assert (float(got["test_bin_loss"]) > 0) == (epoch > 0)
    record = json.loads((tmp_path / "t" / "test_metrics.jsonl").read_text())
    assert record["test_loss"] == got["test_loss"] and "time" in record
    assert model.module.training


def test_run_test_sets_names_index_and_epoch_rule(corpus, weights, tmp_path):
    cfg = _test_cfg(corpus, tmp_path, batch_size=2)
    model = FastPitchModel(cfg["model"])
    from roar_tpu_torch.training import convert

    convert.load_fastpitch_params(model.module, weights)
    ds = run.build_tts_dataset(cfg["model"]["train_ds"]["dataset"], model.tokenizer, "cpu")
    cfg["model"]["test_ds"]["test_dl_idx"] = 1
    out = run.run_test(cfg, model, {"a_": ds, "b_": ds}, buckets=BucketSpec(), device="cpu")
    assert {"a_test_loss", "b_test_loss", "test_loss"} <= set(out)
    assert out["test_loss"] == out["b_test_loss"] == out["a_test_loss"]
    cfg["model"]["test_ds"]["test_dl_idx"] = 2
    with pytest.raises(ValueError, match="test_dl_idx=2"):
        run.run_test(cfg, model, [ds, ds], device="cpu")
    # the end-of-training epoch: max_epochs 4, max_steps 3, step 3 -> epoch 4;
    # at step 1 -> round(4/3) = 1; untrained -> 0
    cfg["model"]["test_ds"]["test_dl_idx"] = 0
    seen = []
    real = model.loss_fn
    model.loss_fn = lambda batch, epoch, mark=None: (seen.append(epoch), real(batch, epoch))[1]
    for step, want in ((3, 4), (1, 1), (0, 0)):
        seen.clear()
        run.run_test(cfg, model, ds, state=TrainState(model=model, opt=None, step=step),
                     device="cpu")
        assert set(seen) == {want}, (step, seen)


def test_early_stopping_stops_train_supervised_after_two_of_six_epochs(corpus, tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    cfg = _quiet(_train_cfg(corpus, tmp_path / "exp", "trainer.max_epochs=6",
                            "trainer.max_steps=100", "+exp_manager.create_early_stopping_callback=true",
                            "+exp_manager.early_stopping_callback_params.monitor=val_loss",
                            "+exp_manager.early_stopping_callback_params.min_delta=1e9",
                            "+exp_manager.early_stopping_callback_params.patience=0",
                            "+exp_manager.early_stopping_callback_params.strict=true"))
    state = fastpitch_torch.run(cfg)
    assert state.step == 4  # two epochs of two steps
    root = tmp_path / "exp" / "FastPitch"
    val = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()
           if "val_loss" in line]
    assert len(val) == 2
    assert (root / "checkpoints" / "step_4.pt").exists()
    assert signal.getsignal(signal.SIGTERM) == before


def test_profiler_window_artifacts_and_snapshot(corpus, tmp_path):
    """`model.profile` traces steps 2 and 3 on the CPU; `log_artifacts`
    writes the plots and a Griffin-Lim preview that is finite and not all
    zero; the snapshot files are there."""
    cfg = _quiet(_train_cfg(corpus, tmp_path / "exp", "trainer.max_epochs=2",
                            "trainer.max_steps=4", "+exp_manager.log_artifacts=true",
                            "+model.profile.enabled=true", "+model.profile.start_step=1",
                            "+model.profile.end_step=3"))
    fastpitch_torch.run(cfg)
    root = tmp_path / "exp" / "FastPitch"
    summary = json.loads((root / "profile" / "summary.json").read_text())
    assert (summary["first_step"], summary["last_step"]) == (2, 3)
    trace = json.loads(Path(summary["trace"]).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
    assert summary["device_busy_ms"] == 0.0 and summary["wall_ms"] > 0  # no device here
    wavs = sorted((root / "artifacts").glob("epoch*_preview.wav"))
    assert wavs and sorted((root / "artifacts").glob("epoch*_spec_pred.png"))
    audio, sr = read_wav(str(wavs[0]))
    assert sr == 22050 and np.isfinite(audio).all() and np.abs(audio).max() > 0
    for name in ("cmd-args.log", "config.yaml"):
        assert (root / name).exists()


def test_profiler_window_counts_steps_on_the_host(tmp_path):
    window = run.ProfilerWindow({"enabled": True, "start_step": 2, "end_step": 4},
                                str(tmp_path / "p"))
    cb = window.as_callback()
    x = torch.ones(64, 64)
    for _ in range(5):
        x = x @ x / 64
        cb(None, None)
    assert window.trace_path.name == "trace_steps_3_4.json" and window.trace_path.exists()
    assert run.ProfilerWindow(None, str(tmp_path)).as_callback() is None
    busy = run.device_busy(window.trace_path)
    assert busy == {"device_busy_ms": 0.0, "device_kernels": {}}


def test_device_busy_is_the_union_of_kernel_intervals(tmp_path):
    trace = {"traceEvents": [
        {"cat": "kernel", "name": "a", "ts": 0, "dur": 10},
        {"cat": "kernel", "name": "b", "ts": 5, "dur": 10},
        {"cat": "kernel", "name": "a", "ts": 30, "dur": 5},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    assert run.device_busy(path) == {"device_busy_ms": 0.02, "device_kernels": {"a": 2, "b": 1}}


def test_the_sigterm_handler_is_put_back_after_a_failed_run(corpus, tmp_path, monkeypatch):
    before = signal.getsignal(signal.SIGTERM)
    cfg = _quiet(_train_cfg(corpus, tmp_path / "exp"))

    def fail(*args, **kwargs):
        raise RuntimeError("a step failed")

    monkeypatch.setattr(run.Trainer, "run_epoch", fail)
    with pytest.raises(RuntimeError, match="a step failed"):
        fastpitch_torch.run(cfg)
    assert signal.getsignal(signal.SIGTERM) == before


def test_chip_smoke_finetune_phase_rehearses_on_the_cpu(tmp_path):
    """Phase finetune_fastpitch of chip_smoke.py at a narrow width on the
    CPU, on the corpus, sup-data and bundle phase train_fastpitch keeps:
    every check of the card's run but the launch counts and the timing."""
    sys.path.insert(0, str(TESTS.parent))
    import chip_smoke as cs

    kept = cs.phase_train_fastpitch(torch.device("cpu"), n_utterances=8, steps=4, batch_size=2,
                                    max_seconds=1.5, narrow=True,
                                    keep_dir=str(tmp_path))["kept"]
    out = cs.phase_finetune_fastpitch(torch.device("cpu"), kept, n_utterances=4, n_test=2,
                                      batch_size=2, narrow=True)
    assert out["profile"]["first_step"] == 3 and "timing" not in out
