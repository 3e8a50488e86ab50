"""The standalone Aligner, port against the JAX package, on the CPU at a small
size (embedding 32, 12 attention channels, 16 mel bands, 72 mel frames); and
the recipe it starts, end to end: examples/tts/aligner_torch.py on a tiny
manifest, `align`'s durations written as `.npy` files, then the FastPitch CLI
without learned alignment trained on them.

The loss is forward-sum plus the binarization loss, which switches on at
epoch ceil(bin_loss_start_ratio * max_epochs) = 2 here with a scale that grows
over `bin_loss_warmup_epochs` = 4 from a floor of 1/4: epochs 0 and 1 carry no
bin term, 2 the floor, 4 a half, 7 all of it.  Loss terms, gradients and 3
Adam steps at rtol 3e-3; `align`'s durations equal to the JAX ones.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import test_torch_fastpitch_train as fp_tests
import torch
from test_torch_train_supervised import corpus  # noqa: F401  (fixture: 4 utterances, sup-data)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from roar_tpu_torch.data.dataset import BucketSpec, TTSDataset
from roar_tpu_torch.models.aligner_model import AlignerModel
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import TrainState, train_step

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=3e-3, atol=1e-6)
EPOCHS = (0, 1, 2, 4, 7)
SCALES = (0.0, 0.0, 0.25, 0.5, 1.0)
OPTIM = {"name": "adam", "lr": 1e-3}
N_STEPS = 3


def _cfg():
    return {"n_symbols": 40, "symbols_embedding_dim": 32, "bin_loss_start_ratio": 0.2,
            "bin_loss_warmup_epochs": 4, "max_epochs": 10,
            "preprocessor": fp_tests._cfg()["preprocessor"],
            "alignment_encoder": {"n_att_channels": 12}}


def _batch_np():
    batch = fp_tests._batch_np()
    return {k: batch[k] for k in ("audio", "audio_len", "text", "text_len", "mel_len",
                                  "align_prior_matrix")}


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch_np().items()}


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    from roar_tpu.models.aligner_model import AlignerModel as JaxAlignerModel
    from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
    from roar_tpu.training.trainer import create_train_state, make_train_step

    model = JaxAlignerModel(_cfg())
    batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    params = jax.device_get(model.init_params(jax.random.PRNGKey(0), batch))
    loss_and_grads = jax.jit(jax.value_and_grad(
        lambda p, epoch: model.loss_fn(p, batch, None, epoch), has_aux=True))
    by_epoch = {}
    for epoch in EPOCHS:
        (_, metrics), grads = jax.device_get(loss_and_grads(params, epoch))
        by_epoch[epoch] = ({k: float(v) for k, v in metrics.items()}, grads)
    optimizer = jax_build_optimizer(OPTIM)
    step = make_train_step(lambda p, b, rng, epoch: model.loss_fn(p, b, rng, epoch), optimizer,
                           donate=False)
    state = create_train_state(params, optimizer)
    trajectory = []
    for _ in range(N_STEPS):
        state, metrics = step(state, batch, jax.random.PRNGKey(0), EPOCHS[-1])
        trajectory.append({k: float(v) for k, v in metrics.items()})
    durs, soft = jax.device_get(model.align(params, _batch_np()))
    return {"params": params, "by_epoch": by_epoch, "trajectory": trajectory,
            "final": jax.device_get(state.params), "durs": np.asarray(durs),
            "soft": np.asarray(soft)}


def _port_model(params):
    model = AlignerModel(_cfg())
    convert.load_aligner_params(model.module, params)
    return model


def test_parameter_tree_round_trips_and_unconsumed_leaves_raise(jax_side):
    model = _port_model(jax_side["params"])
    got = convert.flatten_params(model.to_jax_tree())
    want = convert.flatten_params(jax_side["params"])
    assert set(got) == set(want) and "embed/embedding" in want
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    extra = convert._nest({tuple(k.split("/")): v for k, v in
                           {**want, "embed/stray": np.zeros(1, np.float32)}.items()})
    with pytest.raises(ValueError, match="not consumed"):
        convert.load_aligner_params(AlignerModel(_cfg()).module, extra)
    short = convert._nest({tuple(k.split("/")): v for k, v in want.items()
                           if k != "embed/embedding"})
    with pytest.raises(KeyError, match="unfilled"):
        convert.load_aligner_params(AlignerModel(_cfg()).module, short)


@pytest.mark.parametrize("epoch,scale", list(zip(EPOCHS, SCALES)))
def test_loss_terms_and_gradients_around_the_bin_loss_gate_match_jax(jax_side, epoch, scale):
    model = _port_model(jax_side["params"])
    assert model.bin_loss_start_epoch == 2 and model.bin_loss_scale(epoch) == scale
    want, grads = jax_side["by_epoch"][epoch]
    loss, metrics = model.loss_fn(_torch_batch(), epoch)
    assert set(metrics) == set(want) == {"forward_sum_loss", "bin_loss", "loss"}
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    assert (float(metrics["bin_loss"]) > 0.0) == (scale > 0.0)
    loss.backward()
    grad_model = AlignerModel(_cfg())
    with torch.no_grad():
        for dst, src in zip(grad_model.module.parameters(), model.module.parameters()):
            dst.copy_(src.grad)
    scale_g = max(float(np.abs(v).max()) for v in convert.flatten_params(grads).values())
    fp_tests._assert_tree_close(grad_model.to_jax_tree(), grads, f"grad at epoch {epoch}",
                                rtol=3e-3, atol=3e-6 * scale_g)


def test_three_adam_steps_follow_the_jax_trajectory(jax_side):
    model = _port_model(jax_side["params"])
    state = TrainState(model=model, opt=build_optimizer(model.parameters(), OPTIM))
    batch = _torch_batch()
    for want in jax_side["trajectory"]:
        state, metrics = train_step(state, batch, EPOCHS[-1])
        assert set(metrics) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    fp_tests._assert_tree_close(model.to_jax_tree(), jax_side["final"], "params", rtol=3e-3,
                                atol=2e-4)


def test_align_durations_equal_jax_and_sum_to_the_mel_lengths(jax_side):
    model = _port_model(jax_side["params"])
    durs, soft = model.align(_torch_batch())
    np.testing.assert_array_equal(durs.numpy(), jax_side["durs"])
    np.testing.assert_allclose(soft.numpy(), jax_side["soft"], atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(durs.sum(1).numpy(), _batch_np()["mel_len"])
    assert not model.module.training


# ---------------------------------------------------------------------------
# The recipe: aligner CLI -> durations -> FastPitch CLI without learned alignment
# ---------------------------------------------------------------------------


def test_aligner_cli_durations_train_fastpitch_without_alignment(corpus, tmp_path):  # noqa: F811
    sys.path.insert(0, str(REPO / "examples" / "tts"))
    import aligner_torch
    import fastpitch_torch
    import test_torch_train_supervised as sup_tests

    from roar_tpu_torch.data.manifest import read_manifest, write_manifest
    from roar_tpu_torch.training.trainer import to_device

    manifest, sup, _ = corpus
    state = aligner_torch.main([
        "--config-name=aligner", f"train_dataset={manifest}", f"sup_data_path={sup}",
        "n_window_size=2048", "n_window_stride=512", "n_fft=2048",
        "model.symbols_embedding_dim=32", "model.alignment_encoder.n_att_channels=16",
        "trainer.max_epochs=3", "model.max_epochs=3", "trainer.log_every_n_steps=1",
        "model.train_ds.dataloader_params.batch_size=2",
        "model.train_ds.dataloader_params.num_workers=0",
        f"exp_manager.exp_dir={tmp_path / 'exp'}", "exp_manager.create_tensorboard_logger=false",
        "+exp_manager.always_save_roar=true", "+device=cpu"])
    model = state.model
    assert state.step == 6 and model.bin_loss_start_epoch == 1
    root = tmp_path / "exp" / "Aligner"
    records = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "forward_sum_loss" in r]
    assert [r["step"] for r in steps] == list(range(1, 7))
    assert all(np.isfinite(r["loss"]) for r in steps)
    assert steps[1]["bin_loss"] == 0.0 and steps[2]["bin_loss"] > 0.0  # epoch 1 switches it on
    assert (root / "checkpoints" / "Aligner.roar").exists()

    # durations of every utterance, in FastPitch's frames
    dataset = TTSDataset(manifest, 22050, model.tokenizer, sup_data_path=sup,
                         sup_data_types=["align_prior_matrix"], n_fft=2048, hop_length=512,
                         highfreq=8000, device="cpu")
    entries = read_manifest(manifest)
    batch = to_device(dataset.collate([dataset[i] for i in range(len(dataset))], BucketSpec()),
                      torch.device("cpu"))
    durs, _ = model.align(batch)
    np.testing.assert_array_equal(durs.sum(1).numpy(), batch["mel_len"].numpy())
    for i, e in enumerate(entries):
        path = tmp_path / f"durs_{i}.npy"
        np.save(path, durs[i, :int(batch["text_len"][i])].numpy().astype(np.int32))
        e["duration_filepath"] = str(path)
    durations_manifest = str(tmp_path / "manifest_durations.json")
    write_manifest(durations_manifest, entries)

    cfg = sup_tests._train_cfg((durations_manifest, *corpus[1:]), tmp_path / "fp",
                               "model.learn_alignment=false", "model.alignment_module=null",
                               "model.input_fft.remat=true", "model.output_fft.remat=true")
    for ds in ("train_ds", "validation_ds"):
        cfg["model"][ds]["dataset"]["sup_data_types"] = ["pitch", "speaker_id", "durations"]
    fp_state = fastpitch_torch.run(cfg)
    assert fp_state.step == 3 and not fp_state.model.learn_alignment
    assert fp_state.model.module.decoder_module.remat
    fp_records = [json.loads(line) for line in
                  (tmp_path / "fp" / "FastPitch" / "metrics.jsonl").read_text().splitlines()]
    fp_steps = [r for r in fp_records if "mel_loss" in r]
    assert [r["step"] for r in fp_steps] == [1, 2, 3]
    for r in fp_steps:
        assert "ctc_loss" not in r and all(
            np.isfinite(r[k]) for k in ("loss", "mel_loss", "dur_loss", "pitch_loss"))
    # parse without learned alignment: the ENCharParser, which cleans English
    # text (Tamil letters do not survive its ASCII transliteration)
    ids = fp_state.model.parse("Dr. Smith has 2 cats.")
    assert fp_state.model._parser.decode(ids[0]) == "doctor smith has two cats."
