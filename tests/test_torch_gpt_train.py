"""The port's GPT training slice against the JAX package on the CPU: the task's
loss and every gradient, three AdamW + CosineAnnealing steps, the bf16 step,
gradient accumulation, and the CLI's `run` on a tiny corpus whose `.roar` the
JAX package restores.  Same numpy-seeded batch on both sides, the JAX module's
initial parameters carried over by `load_gpt_params`.  fp32: rtol 3e-3."""

import copy
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import jax
import jax.numpy as jnp

from roar_tpu.models.gpt_model import GPTLMModel as JaxGPTLMModel
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu.training.save_restore import restore_from as jax_restore_from
from roar_tpu.training.trainer import create_train_state, make_train_step
from roar_tpu_torch.config.config import load_config
from roar_tpu_torch.data.lm_dataset import CausalLMDataset, SimpleWordTokenizer, find_newlines
from roar_tpu_torch.models.gpt_model import GPTLMModel
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import Trainer, TrainState, to_device, train_step

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "gpt_pretraining_torch", REPO / "examples" / "nlp" / "gpt_pretraining_torch.py")
gpt_pretraining_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gpt_pretraining_torch)

TOL = dict(rtol=3e-3, atol=1e-5)
N_STEPS = 3
CLIP = 1.0
OPTIM = {"name": "adamw", "lr": 3e-4, "weight_decay": 0.1, "betas": [0.9, 0.95],
         "sched": {"name": "CosineAnnealing", "warmup_ratio": 0.02, "min_lr": 3e-5,
                   "max_steps": 10}}
VOCAB, SEQ = 70, 24


def _cfg(**extra):
    """tiny-llama's family at 2 layers and narrow widths, `config_name` with
    overrides as the CLI builds it."""
    return {"config_name": "tiny-llama-1.1b", "n_layer": 2, "n_embd": 64, "n_head": 4,
            "n_query_groups": 2, "intermediate_size": 96, "vocab_size": VOCAB,
            "padding_multiple": 1, "block_size": SEQ, "use_flash": True, **extra}


def _batch_np(mask=False):
    rng = np.random.default_rng(0)
    window = rng.integers(0, VOCAB, (3, SEQ + 1)).astype(np.int32)
    batch = {"input_ids": window[:, :-1], "labels": window[:, 1:]}
    if mask:
        batch["loss_mask"] = (rng.random((3, SEQ)) < 0.8).astype(np.float32)
    return batch


def _torch_batch(**kw):
    return to_device(_batch_np(**kw), torch.device("cpu"))


def _port_model(params, **extra):
    model = GPTLMModel(_cfg(**extra))
    convert.load_gpt_params(model.module, jax.device_get(params))
    return model


def _grad_tree(model):
    grads = copy.deepcopy(model.module)
    with torch.no_grad():
        for dst, src in zip(grads.parameters(), model.module.parameters()):
            dst.copy_(src.grad)
    return convert.gpt_to_jax_tree(grads)


def _assert_tree_close(got, want, what, rtol, atol):
    got_flat, want_flat = flatten_dict(got), flatten_dict(jax.device_get(want))
    assert set(got_flat) == set(want_flat)
    for path, value in want_flat.items():
        np.testing.assert_allclose(got_flat[path], np.asarray(value), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for fused in (True, False):
        model = JaxGPTLMModel(_cfg(fused_ce=fused))
        batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
        params = out.get("params_j") or model.init_params(jax.random.PRNGKey(0), batch)
        out["params_j"] = params
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss_fn(p, batch), has_aux=True))(params)
        out[fused] = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
                      "grads": jax.device_get(grads)}
    model = JaxGPTLMModel(_cfg())
    masked = {k: jnp.asarray(v) for k, v in _batch_np(mask=True).items()}
    out["masked"] = {k: float(v) for k, v in model.loss_fn(params, masked)[1].items()}

    def trajectory(precision):
        optimizer = jax_build_optimizer(OPTIM, gradient_clip_val=CLIP)
        step = make_train_step(lambda p, b, rng, epoch: model.loss_fn(p, b), optimizer,
                               donate=False, precision=precision)
        state = create_train_state(params, optimizer)
        steps = []
        for _ in range(N_STEPS):
            state, metrics = step(state, batch, jax.random.PRNGKey(0), 0)
            steps.append({k: float(v) for k, v in metrics.items()})
        return steps, jax.device_get(state.params)

    out["trajectory"], out["final"] = trajectory(None)
    out["trajectory_bf16"], _ = trajectory("bf16")
    out["params"] = jax.device_get(params)
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["fused_ce", "unfused"])
def test_loss_metrics_and_every_gradient_match_jax(jax_side, fused):
    model = _port_model(jax_side["params"], fused_ce=fused)
    loss, metrics = model.loss_fn(_torch_batch())
    want = jax_side[fused]
    assert set(metrics) == set(want["metrics"]) == {"loss", "ppl", "token_acc"}
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    loss.backward()
    scale = max(float(np.abs(v).max()) for v in flatten_dict(want["grads"]).values())
    _assert_tree_close(_grad_tree(model), want["grads"], "grad", rtol=3e-3, atol=3e-6 * scale)


def test_loss_mask_weights_the_mean_as_jax_does(jax_side):
    model = _port_model(jax_side["params"])
    _, metrics = model.loss_fn(_torch_batch(mask=True))
    for k, v in jax_side["masked"].items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    _, unfused = _port_model(jax_side["params"], fused_ce=False).loss_fn(_torch_batch(mask=True))
    for k in metrics:
        np.testing.assert_allclose(float(unfused[k]), float(metrics[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("remat", [None, "nothing", "flash"])
def test_three_adamw_cosine_steps_follow_the_jax_trajectory(jax_side, remat):
    """Metrics per step, `grad_norm` included, and the parameters after three
    updates; with `remat` and either policy the same trajectory."""
    extra = {} if remat is None else {"remat": True, "remat_policy": remat, "scan_layers": True}
    model = _port_model(jax_side["params"], **extra)
    opt = build_optimizer(model.parameters(), OPTIM, gradient_clip_val=CLIP)
    state = TrainState(model=model, opt=opt)
    batch = _torch_batch()
    for want in jax_side["trajectory"]:
        state, metrics = train_step(state, batch)
        assert set(metrics) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    assert state.step == N_STEPS and opt.count == N_STEPS
    # AdamW moves a weight by about lr a step whatever its gradient's size:
    # atol 2e-4 covers entries whose gradient is near rounding level over 3
    # steps of lr 3e-4
    unrolled = convert.gpt_to_jax_tree(_port_model(convert.gpt_to_jax_tree(model.module)).module)
    _assert_tree_close(unrolled, jax_side["final"], "params", rtol=3e-3, atol=2e-4)


def test_bf16_steps_keep_fp32_masters_and_follow_jax_loosely(jax_side):
    """`precision="bf16"`: masters, gradients and optimizer state stay fp32,
    the loss follows JAX's bf16 trajectory.  Both sides round to bf16 at
    other places (the JAX einsum route takes its softmax in bf16, the port's
    flash plain version in fp32): the loss, near log(70) = 4.2, is held to
    2e-2, about 1.5 bf16 steps (2^-8 relative) of the logits it sums."""
    model = _port_model(jax_side["params"])
    opt = build_optimizer(model.parameters(), OPTIM, gradient_clip_val=CLIP)
    trainer = Trainer(model=model, optimizer=opt, device="cpu", precision="bf16")
    state = trainer.init_state()
    assert model.module.compute_dtype == torch.bfloat16
    batch = _torch_batch()
    for want in jax_side["trajectory_bf16"]:
        state, metrics = train_step(state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), want["loss"], atol=2e-2, rtol=0)
        np.testing.assert_allclose(float(metrics["grad_norm"]), want["grad_norm"], rtol=5e-2)
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    moments = [v for s in opt.optimizer.state.values() for v in s.values() if v.dim() > 0]
    assert moments and all(m.dtype == torch.float32 for m in moments)
    # and the bf16 trajectory is not the fp32 one
    assert abs(jax_side["trajectory_bf16"][0]["loss"] - jax_side["trajectory"][0]["loss"]) > 1e-6


def test_bf16_validation_runs_in_fp32_from_the_masters(jax_side):
    """After one bf16 step, `Trainer.evaluate` gives what the JAX runner's
    validation gives: the loss of the fp32 masters on the uncast batch (the
    port's own fp32 forward, and the JAX task's `loss_fn` on the same masters,
    at rtol 3e-3), not the bf16 forward's; the bf16 compute type is back
    after it."""
    model = _port_model(jax_side["params"])
    opt = build_optimizer(model.parameters(), OPTIM, gradient_clip_val=CLIP)
    trainer = Trainer(model=model, optimizer=opt, device="cpu", precision="bf16")
    state = trainer.init_state()
    state, _ = train_step(state, _torch_batch())
    val = trainer.evaluate(state, [_batch_np()])
    assert model.module.compute_dtype == torch.bfloat16 and model.module.training
    model.set_compute_dtype(None)
    with torch.no_grad():
        _, fp32 = model.loss_fn(_torch_batch())
    model.set_compute_dtype(torch.bfloat16)
    with torch.no_grad():
        _, bf16 = model.loss_fn(_torch_batch())
    jmodel = JaxGPTLMModel(_cfg())
    masters = convert.gpt_to_jax_tree(model.module)
    _, want = jmodel.loss_fn(masters, {k: jnp.asarray(v) for k, v in _batch_np().items()},
                             deterministic=True)
    assert set(val) == set(want) == {"loss", "ppl", "token_acc"}
    for k in val:
        np.testing.assert_allclose(val[k], float(fp32[k]), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(val[k], float(want[k]), err_msg=k, **TOL)
    assert val["loss"] != float(bf16["loss"])  # the bf16 forward gives another loss


def test_bf16_raises_for_a_task_without_a_bf16_form():
    class Task:
        module = torch.nn.Linear(2, 2)

    with pytest.raises(NotImplementedError, match="bf16"):
        Trainer(model=Task(), optimizer=None, device="cpu", precision="bf16")


def test_gradient_accumulation_averages_micro_batches(jax_side):
    """Two equal micro-batches with accumulate_grad_batches=2 make one update
    equal to one step on that batch."""
    one, two = _port_model(jax_side["params"]), _port_model(jax_side["params"])
    batch = _torch_batch()
    state = TrainState(model=one, opt=build_optimizer(one.parameters(), OPTIM))
    train_step(state, batch)
    state2 = TrainState(model=two, opt=build_optimizer(two.parameters(), OPTIM))
    train_step(state2, batch, accumulate_grad_batches=2)
    assert state2.opt.count == 0
    train_step(state2, batch, accumulate_grad_batches=2)
    assert state2.opt.count == 1 and state2.step == 2
    for a, b in zip(one.parameters(), two.parameters()):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_config_name_precedence_is_the_jax_package_s():
    """Every GPTConfig field in the model block overrides the registry entry."""
    cfg = {"config_name": "tiny-llama-1.1b", "n_layer": 6, "n_embd": 512, "seq_length": 128}
    assert GPTLMModel(cfg).config.__dict__ == JaxGPTLMModel(cfg).config.__dict__
    assert GPTLMModel(cfg).config.n_layer == 6
    plain = {"n_layer": 1, "n_embd": 32, "n_head": 2, "vocab_size": 40, "fused_ce": False}
    assert GPTLMModel(plain).config.__dict__ == JaxGPTLMModel(plain).config.__dict__
    assert GPTLMModel(plain).fused_ce is False and GPTLMModel(cfg).fused_ce is True


# ---------------------------------------------------------------------------
# the data layer and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpt_corpus")
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(60)]
    weights = 1.0 / np.arange(1, 61)
    paths = {}
    for name, n_lines in (("train", 120), ("val", 30)):
        lines = [" ".join(rng.choice(words, rng.integers(4, 30), p=weights / weights.sum()))
                 for _ in range(n_lines)]
        lines.insert(5, "")  # an empty line is skipped
        paths[name] = root / f"{name}.txt"
        paths[name].write_text("\n".join(lines) + "\n")
    return paths


def test_tokenizer_and_dataset_equal_the_jax_package_s(corpus):
    from roar_tpu.data import lm_dataset as jlm

    files = [str(corpus["train"]), str(corpus["val"])]
    tok, jtok = SimpleWordTokenizer(files, max_vocab=50), jlm.SimpleWordTokenizer(files, 50)
    assert tok.vocab_size == jtok.vocab_size == 50
    assert tok.ids_to_tokens(range(50)) == jtok.ids_to_tokens(range(50))
    text = "w0 w3 nope w59"
    assert tok.text_to_ids(text) == jtok.text_to_ids(text)
    assert (tok.pad_id, tok.eos_id, tok.unk_id) == (jtok.pad_id, jtok.eos_id, jtok.unk_id)
    ds, jds = CausalLMDataset(tok, files[0], 16), jlm.CausalLMDataset(jtok, files[0], 16)
    assert len(ds) == len(jds) and ds.lengths == jds.lengths
    for i in (0, len(ds) - 1):
        for key in ("input_ids", "labels"):
            np.testing.assert_array_equal(ds[i][key], jds[i][key])
    np.testing.assert_array_equal(ds[0]["input_ids"][1:], ds[0]["labels"][:-1])
    batch = ds.collate([ds[0], ds[1]])
    assert batch["input_ids"].shape == (2, 16)
    with pytest.raises(ValueError, match="fewer"):
        CausalLMDataset(tok, files[0], 10 ** 6)
    blob = corpus["train"].read_bytes()
    np.testing.assert_array_equal(find_newlines(blob), jlm.find_newlines(blob))


def _train_cfg(corpus, tmp_path, *more):
    return load_config(REPO / "configs" / "gpt_pretraining.yaml", overrides=[
        f"train_dataset={corpus['train']}", f"validation_dataset={corpus['val']}",
        "model.n_layer=2", "model.n_embd=64", "model.n_head=4", "model.n_query_groups=2",
        "model.intermediate_size=96", "model.seq_length=32", "model.block_size=32",
        "model.use_flash=true", "+model.scan_layers=true", "+model.remat=true",
        "+model.remat_policy=flash", "model.train_ds.dataloader_params.batch_size=2",
        "trainer.max_epochs=2", "trainer.log_every_n_steps=1", "+trainer.seed=0",
        "+trainer.accumulate_grad_batches=2", f"exp_manager.exp_dir={tmp_path}",
        "+exp_manager.always_save_roar=true", "+device=cpu", *more])


# pythia-1b's family at 2 layers, narrow, with heads of 256: every field of
# the YAML's model block that would override the entry's own set to its value
PYTHIA_D256 = ("+model.config_name=pythia-1b", "model.n_embd=512", "model.n_head=2",
               "model.norm_class=LayerNorm", "model.mlp_class=GptNeoxMLP")


@pytest.mark.parametrize("precision,family", [("32", ()), ("bf16", ()), ("32", PYTHIA_D256)],
                         ids=["32", "bf16", "32-pythia-d256"])
def test_cli_run_trains_and_the_jax_package_restores_its_bundle(corpus, tmp_path, precision,
                                                                 family):
    """The CLI's `run` on a tiny corpus: the loss falls, validation is logged,
    and the end-of-training `.roar` (stacked `h_scan` layout, fp32 masters)
    is restored by the JAX package's `restore_from` and gives the port's
    logits.  In tiny-llama's family in fp32 and bf16, and in pythia-1b's at
    head size 256 in fp32 (the YAML's own precision)."""
    cfg = _train_cfg(corpus, tmp_path, f"+trainer.precision={precision}", *family)
    state = gpt_pretraining_torch.run(cfg)
    model = state.model
    if family:
        assert (model.config.head_size, model.config.parallel_residual) == (256, True)
        assert model.module.compute_dtype is None
    n_blocks = len(CausalLMDataset(SimpleWordTokenizer([str(corpus["train"])]),
                                   str(corpus["train"]), 32))
    assert state.step == 2 * (n_blocks // 2) and state.opt.count == state.step // 2
    assert model.config.vocab_size == 66 and model.config.scan_layers
    root = Path(tmp_path) / "GPTPretraining"
    records = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    train = [r["loss"] for r in records if "loss" in r]
    assert len(train) == state.step and np.isfinite(train).all()
    assert np.mean(train[-4:]) < np.mean(train[:4])
    val = [r for r in records if "val_loss" in r]
    assert len(val) == 2 and {"val_ppl", "val_token_acc"} <= set(val[0])
    path = root / "checkpoints" / "GPTPretraining.roar"
    assert path.exists()

    saved_cfg, params = jax_restore_from(str(path))
    jmodel = JaxGPTLMModel(dict(saved_cfg["model"]))
    assert jmodel.config.__dict__ == model.config.__dict__
    flat = convert.flatten_params(params)
    assert all(v.dtype == np.float32 for v in flat.values())
    assert "h_scan/attn/attn/kernel" in flat and flat["h_scan/attn/attn/kernel"].shape[0] == 2
    tokens = np.random.default_rng(5).integers(0, 66, (2, 32)).astype(np.int32)
    want = np.asarray(jmodel.module.apply(params, jnp.asarray(tokens)))
    model.set_compute_dtype(None)
    with torch.no_grad():
        got = model.module(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    # and the port's own converter loads it back
    again = GPTLMModel(dict(saved_cfg["model"]))
    convert.load_gpt_params(again.module, params)
    for a, b in zip(again.parameters(), model.parameters()):
        assert torch.equal(a, b)


def _assert_subdict(small, big, path=""):
    for key, value in small.items():
        assert key in big, f"{path}{key} not in the YAML"
        if isinstance(value, dict):
            _assert_subdict(value, big[key], f"{path}{key}.")
        else:
            assert value == big[key], f"{path}{key}: {value!r} != {big[key]!r}"


def test_chip_smoke_gpt_config_is_the_yaml_s_but_for_the_model_block():
    """The config `chip_smoke.py` trains GPT at: the YAML's optimizer,
    schedule, clip and logger blocks under the overrides its docstring names,
    and a model block of `config_name` plus the fields it means to change, so
    that nothing of the YAML's 6-layer model overrides tiny-llama-1.1b."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    yaml_cfg = load_config(REPO / "configs" / "gpt_pretraining.yaml", overrides=[
        "train_dataset=t.txt", "validation_dataset=v.txt", "exp_manager.exp_dir=e",
        "model.train_ds.dataloader_params.batch_size=1", "trainer.log_every_n_steps=1",
        "trainer.max_steps=1000", "+trainer.precision=bf16", "+trainer.accumulate_grad_batches=4", "+trainer.seed=0",
        "+exp_manager.always_save_roar=true", "+device=cuda"])
    got = chip_smoke.gpt_train_config("t.txt", "v.txt", "e")
    model = got.pop("model")
    _assert_subdict(got, yaml_cfg)
    _assert_subdict({k: model[k] for k in ("train_ds", "optim")}, yaml_cfg["model"])
    task = GPTLMModel({k: v for k, v in model.items() if k != "n_layer"} | {"n_layer": 1})
    cfg = task.config
    assert (cfg.n_embd, cfg.n_head, cfg.groups, cfg.head_size, cfg.intermediate_size,
            cfg.padded_vocab, cfg.block_size) == (2048, 32, 4, 64, 5632, 32000, 4096)
    assert cfg.use_flash and cfg.scan_layers and cfg.remat and cfg.remat_policy == "flash"
    assert task.fused_ce
    from roar_tpu_torch.models.gpt import GPT_CONFIGS
    assert GPT_CONFIGS["tiny-llama-1.1b"].n_layer == 22 and "n_layer" not in model
    # 22 layers of (attn 2048 x 2560 + proj 2048^2 + 3 x 2048 x 5632 + 2 norms),
    # the embedding, the head and the final norm
    per_layer = 2048 * 2560 + 2048 * 2048 + 3 * 2048 * 5632 + 2 * 2048
    assert 22 * per_layer + 2 * 32000 * 2048 + 2048 == 1100048384


def test_chip_smoke_gpt_phase_rehearsal_on_the_cpu(capsys):
    """`phase_train_gpt` end to end at a rehearsal width on the CPU: every
    check of the phase but the launch counts and the timing."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    out = chip_smoke.phase_train_gpt(torch.device("cpu"), narrow=True, seq_length=256,
                                     vocab_size=300)
    none = {"fwd": 0, "dkv": 0, "dq": 0}
    assert out == {"launches": none, "launches_bf16": none, "per_micro_batch": none,
                   "fp32_check_launches": none}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    steps = {line["step"]: line for line in lines if line.get("phase") == "train_gpt"}
    assert set(steps) == {"cli", "bundle", "remat_policies", "kernel_path_vs_plain_path"}
    assert steps["cli"]["updates"] == 3 and steps["cli"]["validation_batches"] == 1
    assert steps["cli"]["config"]["vocab_size"] == 300
    assert steps["remat_policies"]["gradients_bit_identical"]
    assert steps["kernel_path_vs_plain_path"]["fp32"]["whole_grad_l2_rel_err"] == 0.0
    bf16 = steps["kernel_path_vs_plain_path"]["bf16"]
    assert bf16["whole_grad_l2_rel_err"] == 0.0 and bf16["grad_l2_tol"] <= 2e-2
    assert bf16["attn_projection_grad_l2_rel_err"]["worst"] == 0.0


def test_chip_smoke_fp32_gpt_run_rehearses_on_the_cpu(capsys):
    """`phase_train_gpt` for pythia-1b at the YAML's own precision (fp32, no
    `trainer.precision`) at a rehearsal width on the CPU: fp32 compute,
    parameters and moments, the loss falling over its 8 updates, the bundle
    equal to the masters, and one micro-batch at full depth with the kernels
    against one with the plain versions (the same plain versions here)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    out = chip_smoke.phase_train_gpt(torch.device("cpu"), narrow=True, seq_length=128,
                                     vocab_size=300, config_name="pythia-1b", precision=None)
    none = {"fwd": 0, "dkv": 0, "dq": 0}
    assert out == {"launches": none, "launches_bf16": none, "per_micro_batch": none,
                   "fp32_check_launches": none}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    steps = {line["step"]: line for line in lines if line.get("phase") == "train_gpt"}
    assert set(steps) == {"cli", "bundle", "remat_policies", "kernel_path_vs_plain_path"}
    cli = steps["cli"]
    assert (cli["precision"], cli["compute_dtype"], cli["updates"]) == ("32", "None", 8)
    assert cli["loss_by_update"][-1] < cli["loss_by_update"][0]
    assert steps["bundle"]["parameters_equal_trained"]
    check = steps["kernel_path_vs_plain_path"]
    assert check["bf16"] is None and check["fp32"]["layers"] == 2
    assert check["fp32"]["whole_grad_l2_rel_err"] == 0.0
