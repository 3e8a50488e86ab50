"""The port's BERT slice against the JAX package on the CPU: the three
pretraining datasets batch for batch (roar_tpu_torch/data/lm_dataset.py), the
modules and the MLM + NSP task (roar_tpu_torch/models/bert.py) with dropout
off, every gradient and three AdamW + cosine steps, the converter both ways,
and the CLI's `run` on a tiny corpus, whose `.roar` the JAX package restores.
The JAX module's initial parameters reach the port through
`load_bert_params`.  Forward: atol 2e-4 / rtol 1e-3; losses, gradients and
steps: rtol 3e-3."""

import copy
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import jax
import jax.numpy as jnp

from roar_tpu.data import lm_dataset as jlm
from roar_tpu.models import bert as jbert
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu.training.save_restore import restore_from as jax_restore_from
from roar_tpu.training.trainer import create_train_state, make_train_step
from roar_tpu_torch.config.config import load_config
from roar_tpu_torch.data import lm_dataset as tlm
from roar_tpu_torch.models import bert as tbert
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import TrainState, to_device, train_step

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-4, rtol=1e-3)
STEP_TOL = dict(rtol=3e-3, atol=1e-5)
N_STEPS = 3
OPTIM = {"name": "adamw", "lr": 1e-3, "weight_decay": 0.01,
         "sched": {"name": "CosineAnnealing", "warmup_ratio": 0.05, "min_lr": 1e-6,
                   "max_steps": 10}}
SEQ = 24


def _cfg(**extra):
    """configs/bert_pretraining.yaml's model block at narrow widths, dropout off."""
    return {"vocab_size": 0, "n_layer": 2, "n_head": 4, "d_model": 64, "d_inner": 96,
            "dropout": 0.0, "dropatt": 0.0, "type_vocab_size": 2, "nsp_weight": 1.0,
            "max_len": 64, **extra}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("bert_corpus")
    rng = np.random.default_rng(11)
    words = [f"w{i}" for i in range(50)] + ["##s", "##ed"]
    paths = {}
    for name, n_lines in (("train", 60), ("val", 20)):
        lines = [" ".join(rng.choice(words, rng.integers(3, 14))) for _ in range(n_lines)]
        lines.insert(4, "")
        paths[name] = root / f"{name}.txt"
        paths[name].write_text("\n".join(lines) + "\n")
    tok = tlm.SimpleWordTokenizer([str(paths["train"]), str(paths["val"])])
    jtok = jlm.SimpleWordTokenizer([str(paths["train"]), str(paths["val"])])
    return paths, tok, jtok


def _datasets(corpus, tmp_path, **kw):
    paths, tok, jtok = corpus
    return (tlm.BertPretrainingDataset(tok, str(paths["train"]), SEQ,
                                       sentence_idx_file=str(tmp_path / "port.pkl"), **kw),
            jlm.BertPretrainingDataset(jtok, str(paths["train"]), SEQ,
                                       sentence_idx_file=str(tmp_path / "jax.pkl"), **kw))


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,short", [(0, 0.1), (3, 0.9)])
def test_raw_text_dataset_gives_the_jax_package_s_batches(corpus, tmp_path, seed, short):
    """Masked sentence pairs, NSP labels and masks, item for item and
    collated, whole-word groups (`##` continuations) included."""
    ds, jds = _datasets(corpus, tmp_path, seed=seed, short_seq_prob=short, mask_prob=0.3)
    assert len(ds) == len(jds) and ds.lengths == jds.lengths
    batch = ds.collate([ds[i] for i in range(len(ds))])
    want = jds.collate([jds[i] for i in range(len(jds))])
    assert set(batch) == set(want) == {"input_ids", "input_type_ids", "input_mask",
                                       "output_ids", "output_mask", "is_next"}
    for k in want:
        assert batch[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    assert batch["output_mask"].sum() > 0 and 0 < batch["is_next"].mean() < 1
    mask_id = corpus[1].mask_id
    assert (batch["input_ids"][batch["output_mask"] > 0] == mask_id).mean() > 0.5


def test_preprocessed_shards_and_the_file_loader_equal_the_jax_package_s(tmp_path):
    rng = np.random.default_rng(5)
    files = []
    for f in range(3):
        n, msl = 7 + f, 16
        lm_pos = np.zeros((n, 5), np.int64)
        for r in range(n):
            k = int(rng.integers(1, 6))
            lm_pos[r, :k] = np.sort(rng.choice(np.arange(1, msl), k, replace=False))
        arrays = {"input_ids": rng.integers(1, 40, (n, msl)),
                  "input_mask": np.ones((n, msl), np.int64),
                  "segment_ids": (np.arange(msl) >= 8).astype(np.int64)[None].repeat(n, 0),
                  "masked_lm_positions": lm_pos,
                  "masked_lm_ids": rng.integers(1, 40, (n, 5)),
                  "next_sentence_labels": rng.integers(0, 2, n)}
        path = tmp_path / f"shard{f}.npz"
        np.savez(path, **arrays)
        files.append(str(path))
    ds = tlm.BertPretrainingPreprocessedDataset(files[0], 5)
    jds = jlm.BertPretrainingPreprocessedDataset(files[0], 5)
    assert len(ds) == len(jds) == 7 and ds.lengths == jds.lengths
    for i in range(7):
        for k, v in jds[i].items():
            np.testing.assert_array_equal(ds[i][k], v, err_msg=k)
    for shards, rank in ((1, 0), (2, 1)):
        loader = tlm.BertPretrainingFileLoader(files, 5, batch_size=2, seed=3,
                                               num_shards=shards, shard_rank=rank)
        jloader = jlm.BertPretrainingFileLoader(files, 5, batch_size=2, seed=3,
                                                num_shards=shards, shard_rank=rank)
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
            got, want = list(loader), list(jloader)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the modules and the task
# ---------------------------------------------------------------------------


def _batch_np(vocab, b=3, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, SEQ)).astype(np.int32)
    ids[1, 17:] = 0  # padding
    types = (np.arange(SEQ)[None] >= 10).astype(np.int32).repeat(b, 0)
    mask = (rng.random((b, SEQ)) < 0.3).astype(np.float32)
    mask[1, 17:] = 0
    return {"input_ids": ids, "input_type_ids": types,
            "output_ids": rng.integers(1, vocab, (b, SEQ)).astype(np.int32),
            "output_mask": mask, "is_next": np.array([1, 0, 1], np.int32)[:b]}


def _pair(cfg):
    jmodel = jbert.BertPretrainingModel(cfg)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0), _batch_np(cfg["vocab_size"])))
    model = tbert.BertPretrainingModel(cfg)
    convert.load_bert_params(model.module, params)
    return jmodel, params, model


@pytest.mark.parametrize("variant", ["mha", "gqa_no_rope_no_types"])
def test_modules_forward_match_jax_with_dropout_off(variant):
    extra = {} if variant == "mha" else {"n_query_groups": 2, "rotary_percentage": 0.0,
                                         "type_vocab_size": 0}
    cfg = _cfg(vocab_size=50, **extra)
    jmodel, params, model = _pair(cfg)
    batch = _batch_np(50)
    ids, types = jnp.asarray(batch["input_ids"]), jnp.asarray(batch["input_type_ids"])
    mlm_j, nsp_j = jmodel.module.apply(params, ids, types)
    model.module.eval()
    tids, ttypes = torch.from_numpy(batch["input_ids"]), torch.from_numpy(batch["input_type_ids"])
    with torch.no_grad():
        mlm, nsp = model.module(tids.long(), ttypes.long())
        seq, pooled = model.module.bert(tids.long(), ttypes.long())
    np.testing.assert_allclose(mlm.numpy(), np.asarray(mlm_j), **TOL)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(nsp_j), **TOL)
    jenc = jbert.BertEncoder(jmodel.config)
    seq_j, pooled_j = jenc.apply({"params": params["params"]["bert"]}, ids, types)
    np.testing.assert_allclose(seq.numpy(), np.asarray(seq_j), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j), **TOL)
    # the MLM-only model on the same encoder and head
    jmlm = jbert.BertForMaskedLM(jmodel.config)
    mlm_params = {"params": {k: params["params"][k] for k in ("bert", "mlm")}}
    tmlm = convert.load_bert_params(tbert.BertForMaskedLM(model.config), mlm_params).eval()
    with torch.no_grad():
        np.testing.assert_allclose(tmlm(tids.long(), ttypes.long()).numpy(),
                                   np.asarray(jmlm.apply(mlm_params, ids, types)), **TOL)


def test_converter_round_trip_and_unconsumed_leaf():
    _, params, model = _pair(_cfg(vocab_size=50))
    back = convert.bert_to_jax_tree(model.module)
    got, want = flatten_dict(back), flatten_dict(params)
    assert set(got) == set(want) and ("params", "mlm", "bias") in got
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    extra = copy.deepcopy(params)
    extra["params"]["pooler"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        convert.load_bert_params(tbert.BertPretrainingModel(_cfg(vocab_size=50)).module, extra)


@pytest.fixture(scope="module")
def jax_side():
    cfg = _cfg(vocab_size=50)
    jmodel, params, _ = _pair(cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch_np(50).items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch, deterministic=True), has_aux=True)(params)
    optimizer = jax_build_optimizer(OPTIM, gradient_clip_val=1.0)
    step = make_train_step(lambda p, b, rng, epoch: jmodel.loss_fn(p, b, deterministic=True),
                           optimizer, donate=False)
    state = create_train_state(params, optimizer)
    steps = []
    for _ in range(N_STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0), 0)
        steps.append({k: float(v) for k, v in m.items()})
    return {"cfg": cfg, "params": params, "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.device_get(grads), "trajectory": steps,
            "final": jax.device_get(state.params)}


def _port_model(jax_side):
    model = tbert.BertPretrainingModel(jax_side["cfg"])
    convert.load_bert_params(model.module, jax_side["params"])
    return model


def test_pretraining_loss_and_every_gradient_match_jax(jax_side):
    model = _port_model(jax_side)
    loss, metrics = model.loss_fn(to_device(_batch_np(50), torch.device("cpu")))
    assert set(metrics) == set(jax_side["metrics"]) == {"loss", "mlm_loss", "nsp_loss", "nsp_acc"}
    for k, v in jax_side["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **STEP_TOL)
    loss.backward()
    grads = copy.deepcopy(model.module)
    with torch.no_grad():
        for dst, src in zip(grads.parameters(), model.module.parameters()):
            dst.copy_(src.grad)
    got, want = flatten_dict(convert.bert_to_jax_tree(grads)), flatten_dict(jax_side["grads"])
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=3e-3, atol=3e-6 * scale,
                                   err_msg="/".join(k))


def test_three_adamw_steps_follow_the_jax_trajectory(jax_side):
    model = _port_model(jax_side)
    opt = build_optimizer(model.parameters(), OPTIM, gradient_clip_val=1.0)
    state = TrainState(model=model, opt=opt)
    batch = to_device(_batch_np(50), torch.device("cpu"))
    for want in jax_side["trajectory"]:
        state, metrics = train_step(state, batch)
        assert set(metrics) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **STEP_TOL)
    got = flatten_dict(convert.bert_to_jax_tree(model.module))
    for k, v in flatten_dict(jax_side["final"]).items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=3e-3, atol=2e-4,
                                   err_msg="/".join(k))


def test_dropout_draws_from_the_task_generator():
    model = tbert.BertPretrainingModel(_cfg(vocab_size=50, dropout=0.1, dropatt=0.1),
                                       generator=torch.Generator().manual_seed(0))
    batch = to_device(_batch_np(50), torch.device("cpu"))
    model.module.train()

    def loss(seed):
        model.set_dropout_generator(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return float(model.loss_fn(batch)[0])

    assert loss(1) == loss(1) != loss(2)
    model.module.eval()
    with torch.no_grad():
        assert float(model.loss_fn(batch)[0]) == float(model.loss_fn(batch)[0])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_run_trains_and_the_jax_package_restores_its_bundle(corpus, tmp_path):
    """`bert_pretraining_torch.run` on configs/bert_pretraining.yaml at
    narrow widths on the CPU: finite losses, validation logged, the `.roar`
    restored by the JAX package equal to the trained parameters, its MLM and
    NSP logits the port's."""
    spec = importlib.util.spec_from_file_location(
        "bert_pretraining_torch", REPO / "examples" / "nlp" / "bert_pretraining_torch.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    paths = corpus[0]
    cfg = load_config(REPO / "configs" / "bert_pretraining.yaml", overrides=[
        f"train_dataset={paths['train']}", f"validation_dataset={paths['val']}",
        "model.n_layer=2", "model.d_model=64", "model.n_head=4", "model.d_inner=96",
        "model.max_seq_length=24", "model.train_ds.dataloader_params.batch_size=8",
        "trainer.max_epochs=2", "trainer.log_every_n_steps=1", f"exp_manager.exp_dir={tmp_path}",
        "+exp_manager.always_save_roar=true", "+device=cpu"])
    state = cli.run(cfg)
    assert state.step == 2 * (61 // 8)
    root = tmp_path / "BertPretraining"
    import json

    records = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "loss" in r]
    assert len(train) == state.step and all(np.isfinite(r["loss"]) for r in train)
    assert any("val_loss" in r and np.isfinite(r["val_mlm_loss"]) for r in records)
    jcfg, params = jax_restore_from(str(root / "checkpoints" / "BertPretraining.roar"))
    module = state.model.module.eval()
    for k, v in flatten_dict(convert.bert_to_jax_tree(module)).items():
        np.testing.assert_array_equal(np.asarray(flatten_dict(params)[k]), v)
    jmodel = jbert.BertPretrainingModel(jcfg["model"])
    batch = _batch_np(jmodel.config.vocab_size)
    want = jmodel.module.apply(params, jnp.asarray(batch["input_ids"]),
                               jnp.asarray(batch["input_type_ids"]))
    with torch.no_grad():
        got = module(torch.from_numpy(batch["input_ids"]).long(),
                     torch.from_numpy(batch["input_type_ids"]).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_chip_smoke_bert_phase_rehearsal(capsys):
    """Phase `train_bert` of chip_smoke.py at a rehearsal width on the CPU:
    every check but the timing."""
    sys.path.insert(0, str(REPO))
    import json

    import chip_smoke

    assert chip_smoke.phase_train_bert(torch.device("cpu"), steps=8, narrow=True) == {
        "steps": 8, "timing": None}
    (line,) = [json.loads(text) for text in capsys.readouterr().out.splitlines()
               if text.startswith('{"phase": "train_bert"')]
    assert line["parameters_equal_trained"] and len(line["mlm_loss"]) == 8
    fixed = line["fixed_batch_eval"]
    assert fixed["trained"]["loss"] < fixed["initial"]["loss"]
    # the phase's config is the YAML's
    yaml_cfg = load_config(REPO / "configs" / "bert_pretraining.yaml",
                           overrides=["train_dataset=t.txt", "validation_dataset=v.txt"])
    got = chip_smoke.bert_train_config("t.txt", "v.txt", "e")
    for key in ("n_layer", "n_head", "d_model", "d_inner", "dropout", "dropatt",
                "type_vocab_size", "max_seq_length", "mask_prob", "vocab_size", "optim"):
        assert got["model"][key] == yaml_cfg["model"][key], key
    assert got["model"]["train_ds"]["dataloader_params"]["batch_size"] == 32
    assert got["trainer"]["gradient_clip_val"] == yaml_cfg["trainer"]["gradient_clip_val"]
