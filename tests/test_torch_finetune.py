"""Adapter fine-tuning of the port against the JAX package, on the CPU.

`AdapterBlock` and a `TransformerLayer` with an adapter (non-zero `up`
weights transplanted, so the adapter's path is exercised); the trainable
labels of a narrow FastPitch with adapters and 3 speakers, leaf for leaf by
flax path; its loss, every gradient and 3 masked AdamW steps against
`masked_optimizer(adamw)` of roar_tpu, frozen leaves exactly unchanged on
both sides; the identity at insertion; `transfer_params`; and the adapters
CLI end to end on a tiny corpus.
"""

import copy
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel
from roar_tpu.models.transformer import AdapterBlock as JaxAdapterBlock
from roar_tpu.models.transformer import TransformerLayer as JaxTransformerLayer
from roar_tpu.training.finetune import count_trainable as jax_count_trainable
from roar_tpu.training.finetune import masked_optimizer as jax_masked_optimizer
from roar_tpu.training.finetune import param_labels as jax_param_labels
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu.training.save_restore import transfer_params as jax_transfer_params
from roar_tpu.training.trainer import create_train_state, make_train_step
from roar_tpu_torch.models.fastpitch_model import FastPitchModel
from roar_tpu_torch.models.transformer import AdapterBlock, TransformerLayer
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.finetune import count_trainable, masked_optimizer, param_labels
from roar_tpu_torch.training.save_restore import restore_from, save_to, transfer_params
from roar_tpu_torch.training.trainer import TrainState, train_step

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
from test_torch_fastpitch_train import (  # noqa: E402
    CLIP, EPOCH, OPTIM, _assert_tree_close, _batch_np, _cfg, _grad_tree, _torch_batch)
from test_torch_train_supervised import _train_cfg, corpus  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401

FWD_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = dict(rtol=3e-3, atol=1e-6)
PATTERNS = [r"adapter", r"speaker_table"]
ADAPTER_DIM = 8
N_STEPS = 3


def _adapter_cfg(**kwargs):
    cfg = _cfg(**kwargs)
    for fft in ("input_fft", "output_fft"):
        cfg[fft] = {**cfg[fft], "adapter_dim": ADAPTER_DIM}
    return cfg


def _nonzero_up(params, rng):
    """`params` with every adapter's `up` kernel and bias drawn at random."""
    flat = flatten_dict(jax.device_get(params))
    for path, value in flat.items():
        if path[-2] == "up" and path[-3] in ("adapter", "params"):
            flat[path] = (0.05 * rng.standard_normal(value.shape)).astype(np.float32)
    from flax.traverse_util import unflatten_dict

    return unflatten_dict(flat)


def test_adapter_block_forward_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    block = JaxAdapterBlock(ADAPTER_DIM)
    params = _nonzero_up(block.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    p = params["params"]
    assert set(p) == {"LayerNorm_0", "down", "up"}
    port = AdapterBlock(16, ADAPTER_DIM)
    assert not port.up.weight.detach().any()  # the identity at construction
    with torch.no_grad():
        port.norm.weight.copy_(torch.tensor(np.asarray(p["LayerNorm_0"]["scale"])))
        port.norm.bias.copy_(torch.tensor(np.asarray(p["LayerNorm_0"]["bias"])))
        for name in ("down", "up"):
            layer = getattr(port, name)
            layer.weight.copy_(torch.tensor(np.asarray(p[name]["kernel"]).T))
            layer.bias.copy_(torch.tensor(np.asarray(p[name]["bias"])))
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(block.apply(params, jnp.asarray(x)))
    assert np.abs(want - x).max() > 1e-2  # the adapter does something
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_transformer_layer_with_adapter_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mask = np.ones((2, 9, 1), np.float32)
    mask[1, 6:] = 0.0
    layer = JaxTransformerLayer(n_head=2, d_model=32, d_head=16, d_inner=48, kernel_size=3,
                                dropout=0.0, dropatt=0.0, adapter_dim=ADAPTER_DIM)
    params = _nonzero_up(layer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask)),
                         rng)
    port = TransformerLayer(2, 32, 16, 48, 3, adapter_dim=ADAPTER_DIM).eval()
    convert.load_fastpitch_params(port, params)
    assert convert.flatten_params(convert.fastpitch_to_jax_tree(port)).keys() == \
        convert.flatten_params(params).keys()
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(layer.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, **FWD_TOL)
    assert np.all(got[1, 6:] == 0.0)


@pytest.fixture(scope="module")
def jax_side():
    """A narrow FastPitch with adapters and 3 speakers: its JAX init with
    non-zero adapter `up` weights, loss and gradients, and 3 masked AdamW
    steps (frozen leaves through `optax.set_to_zero`)."""
    model = JaxFastPitchModel(_adapter_cfg(dropout=0.0, dropatt=0.0))
    batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    params = _nonzero_up(model.init_params(jax.random.PRNGKey(0), batch),
                         np.random.default_rng(2))

    def loss(p, b, rng, epoch):
        return model.loss_fn(p, b, None, epoch, deterministic=True)

    (value, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, batch, None, EPOCH), has_aux=True))(params)
    optimizer = jax_masked_optimizer(jax_build_optimizer(OPTIM, gradient_clip_val=CLIP),
                                     params, PATTERNS)
    step = make_train_step(loss, optimizer, donate=False)
    state = create_train_state(params, optimizer)
    trajectory = []
    for _ in range(N_STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0), EPOCH)
        trajectory.append({k: float(v) for k, v in m.items()})
    return {"params": jax.device_get(params), "loss": float(value),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.device_get(grads), "trajectory": trajectory,
            "final": jax.device_get(state.params),
            "labels": jax_param_labels(params, PATTERNS),
            "counts": jax_count_trainable(params, PATTERNS)}


def _port(params, **kwargs):
    model = FastPitchModel(_adapter_cfg(**kwargs))
    convert.load_fastpitch_params(model.module, params)
    return model


def test_labels_and_counts_match_jax_leaf_for_leaf(jax_side):
    model = _port(jax_side["params"])
    want = {"/".join(k): v for k, v in flatten_dict(jax_side["labels"]).items()}
    got = param_labels(model, PATTERNS)
    assert got == want
    assert sum(v == "trainable" for v in got.values()) == 2 * 2 * 6 + 1  # 4 adapters + table
    assert "params/speaker_table/embedding" in got
    assert count_trainable(model, PATTERNS) == tuple(jax_side["counts"])


def test_loss_and_every_gradient_match_jax(jax_side):
    model = _port(jax_side["params"], dropout=0.0, dropatt=0.0)
    loss, metrics = model.loss_fn(_torch_batch(), EPOCH)
    for k, want in jax_side["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, err_msg=k, **TOL)
    loss.backward()
    want = jax_side["grads"]
    scale = max(float(np.abs(v).max()) for v in flatten_dict(want).values())
    adapters = {k: v for k, v in flatten_dict(want).items() if "adapter" in "/".join(k)}
    assert all(np.abs(v).max() > 0 for v in adapters.values())
    _assert_tree_close(_grad_tree(model), want, "grad", rtol=3e-3, atol=3e-6 * scale)


def test_three_masked_adamw_steps_match_jax(jax_side):
    """Metrics per step (`grad_norm` over every gradient, frozen ones
    included, as the JAX step takes it), the parameters after 3 updates, and
    every frozen parameter exactly where it started on both sides."""
    model = _port(jax_side["params"], dropout=0.0, dropatt=0.0)
    opt = masked_optimizer(OPTIM, model, PATTERNS, gradient_clip_val=CLIP)
    trainable = {id(p) for p in opt.params}
    assert len(trainable) == 2 * 2 * 6 + 1
    start = copy.deepcopy(model.module)
    state = TrainState(model=model, opt=opt)
    batch = _torch_batch()
    for want in jax_side["trajectory"]:
        state, metrics = train_step(state, batch, EPOCH)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    _assert_tree_close(convert.fastpitch_to_jax_tree(model.module), jax_side["final"], "params",
                       rtol=3e-3, atol=2e-4)
    moved = 0
    for (name, p), p0 in zip(model.module.named_parameters(), start.parameters()):
        if id(p) in trainable:
            moved += not torch.equal(p, p0)
            continue
        assert torch.equal(p, p0), f"frozen {name} moved"
        assert p not in opt.optimizer.state
    assert moved == len(trainable)
    labels = {"/".join(k): v for k, v in flatten_dict(jax_side["labels"]).items()}
    initial = convert.flatten_params(jax_side["params"])
    for path, value in convert.flatten_params(jax_side["final"]).items():
        if labels["params/" + path] == "frozen":
            assert np.array_equal(value, initial[path]), f"JAX moved frozen {path}"


def test_adapters_are_the_identity_at_insertion():
    """A seeded FastPitch and the same weights with adapters inserted (zero
    `up`) give the same mel, bit for bit, in eval mode."""
    base = FastPitchModel(_cfg(), generator=torch.Generator().manual_seed(3)).module.eval()
    with_adapters = FastPitchModel(_adapter_cfg(),
                                   generator=torch.Generator().manual_seed(4)).module.eval()
    tree, loaded, skipped = transfer_params(convert.fastpitch_to_jax_tree(with_adapters),
                                            convert.fastpitch_to_jax_tree(base))
    assert all("adapter" in p for p in skipped) and len(skipped) == 4 * 6
    assert len(loaded) == len(convert.flatten_params(convert.fastpitch_to_jax_tree(base)))
    convert.load_fastpitch_params(with_adapters, tree)
    batch = _torch_batch()
    with torch.no_grad():
        a = base.infer(batch["text"].long(), speaker=batch["speaker_id"].long(), max_mel_len=96)
        b = with_adapters.infer(batch["text"].long(), speaker=batch["speaker_id"].long(),
                                max_mel_len=96)
    assert torch.equal(a["spect"], b["spect"])
    assert torch.equal(a["num_frames"], b["num_frames"])


def test_transfer_params_matches_jax():
    src = {"params": {"a": np.ones((2, 2)), "b": np.ones(3), "c": np.ones(4),
                      "n": {"x": np.full(2, 7.0)}}}
    tgt = {"params": {"a": np.zeros((2, 2)), "b": np.zeros(5), "d": np.zeros(4),
                      "n": {"x": np.zeros(2)}}}
    out, loaded, skipped = transfer_params(tgt, src)
    assert np.all(out["params"]["a"] == 1)  # shape match: copied
    assert np.all(out["params"]["b"] == 0)  # shape mismatch: kept
    assert np.all(out["params"]["d"] == 0)  # missing in the source: kept
    assert np.all(out["params"]["n"]["x"] == 7)
    assert np.all(tgt["params"]["a"] == 0)  # the target is not modified
    for kwargs in ({}, {"exclude": ["a"]}, {"include": ["a"]}, {"include": ["n/"],
                                                               "exclude": ["b"]}):
        got = transfer_params(tgt, src, **kwargs)
        want = jax_transfer_params(tgt, src, **kwargs)
        assert got[1] == want[1] and got[2] == want[2], kwargs
        for path, value in convert.flatten_params(want[0]).items():
            np.testing.assert_array_equal(convert.flatten_params(got[0])[path], value)
    assert transfer_params(tgt, src, include=["/a"])[1] == ["params/a"]


def test_adapters_cli_end_to_end_on_the_cpu(corpus, tmp_path):
    """A seeded narrow FastPitch saved as a bundle, then the adapters CLI on
    the tiny corpus for 2 epochs: the frozen parameters stay the bundle's bit
    for bit, every adapter tensor moves, and the logged losses are finite."""
    sys.path.insert(0, str(TESTS.parent / "examples" / "tts"))
    import fastpitch_finetune_adapters_torch as cli

    cfg = _train_cfg(corpus, tmp_path / "exp", "trainer.max_epochs=2",
                     "+pretrained=" + str(tmp_path / "base.roar"), f"+adapter_dim={ADAPTER_DIM}")
    base = FastPitchModel(cfg["model"], generator=torch.Generator().manual_seed(5))
    save_to(str(tmp_path / "base.roar"), {"model": {}}, base.to_jax_tree())
    state = cli.run(cfg)
    model = state.model
    assert state.step == 4 and state.opt.count == 4  # 2 batches of 2, 2 epochs
    _, bundle = restore_from(str(tmp_path / "base.roar"))
    bundle = convert.flatten_params(bundle)
    # the CLI's model before training: seeded by trainer.seed, adapters inserted
    adapted = {**cfg["model"]}
    for fft in ("input_fft", "output_fft"):
        adapted[fft] = {**adapted[fft], "adapter_dim": ADAPTER_DIM}
    initial = convert.flatten_params(FastPitchModel(
        adapted, generator=torch.Generator().manual_seed(0)).to_jax_tree())
    trained = convert.flatten_params(model.to_jax_tree())
    n_adapters = 0
    for path, value in trained.items():
        if "adapter" in path:
            n_adapters += 1
            assert not np.array_equal(value, initial[path]), f"adapter {path} did not move"
        elif "speaker_table" not in path:
            assert np.array_equal(value, bundle[path]), f"frozen {path} moved"
    assert n_adapters == 2 * 6
    root = tmp_path / "exp" / "fastpitch_adapters"
    records = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert records and all(np.isfinite(r["loss"]) for r in records)
    assert (root / "checkpoints" / "step_4.pt").exists()
