"""The port's mixture-of-experts MLP (roar_tpu_torch/models/moe.py) and a
Mixtral-shaped GPT against roar_tpu/models/moe.py and roar_tpu/models/gpt.py
on the CPU.  Same numpy-seeded inputs on both sides, the JAX module's own
initial parameters carried over (`load_gpt_params` for the GPT).  fp32:
forward and aux at atol 2e-4 / rtol 1e-3; the GPT's loss, every gradient and
3 AdamW steps at rtol 3e-3.  bf16: each element within 2^-6 of its value +
2^-7 of the largest magnitude."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import jax
import jax.numpy as jnp

from roar_tpu.models.gpt_model import GPTLMModel as JaxGPTLMModel
from roar_tpu.models.moe import MoEMLP as JaxMoEMLP
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu.training.trainer import create_train_state, make_train_step
from roar_tpu_torch.models import gpt as tgpt
from roar_tpu_torch.models import moe as tmoe
from roar_tpu_torch.models.gpt_model import GPTLMModel
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import Trainer, TrainState, to_device, train_step

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

TOL = dict(atol=2e-4, rtol=1e-3)
GPT_TOL = dict(rtol=3e-3, atol=1e-5)
B, T, D, E, FF, K = 2, 8, 16, 4, 32, 2


def _x(seed=0, b=B, t=T, d=D):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)


def _jax_moe(capacity_factor, x, e=E, ff=FF):
    m = JaxMoEMLP(n_experts=e, ff_dim=ff, top_k=K, capacity_factor=capacity_factor)
    return m, jax.device_get(m.init(jax.random.PRNGKey(1), jnp.asarray(x)))


def _port_moe(params, capacity_factor, dtype=torch.float32):
    p = params["params"]
    e, d, ff = p["w_gate"].shape
    m = tmoe.MoEMLP(d, e, ff, K, capacity_factor)
    with torch.no_grad():
        m.router.weight.copy_(torch.from_numpy(np.array(p["router"]["kernel"]).T))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(m, name).copy_(torch.from_numpy(np.array(p[name])))
    return m.to(dtype)


def _run(m, x, dtype=torch.float32):
    with torch.no_grad():
        y, aux = m(torch.from_numpy(np.array(x)).to(dtype))
    return y.float().numpy(), {k: v.float().numpy() for k, v in aux.items()}


def _oracle(params, x, choice):
    """Per-token loop in fp64 over the given expert choice [N, k]: SwiGLU
    experts, gates renormalised over the chosen experts' probabilities."""
    p = {k: np.asarray(v, np.float64) for k, v in flatten_dict(params["params"]).items()}
    toks = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    logits = toks @ p[("router", "kernel")]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(toks)
    for n, experts in enumerate(choice):
        gates = probs[n, experts] / probs[n, experts].sum()
        for g, e in zip(gates, experts):
            h = toks[n] @ p[("w_gate",)][e]
            out[n] += g * ((h / (1 + np.exp(-h)) * (toks[n] @ p[("w_up",)][e])) @ p[("w_down",)][e])
    return out.reshape(x.shape)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _bf16_close(got, want, what):
    scale = float(np.abs(want).max())
    excess = np.abs(got - want) - (2.0 ** -6 * np.abs(want) + 2.0 ** -7 * scale)
    assert excess.max() <= 0, f"{what}: {excess.max()} over the bf16 bar"


# ---------------------------------------------------------------------------
# MoEMLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5], ids=["ample", "drops"])
def test_forward_and_aux_match_jax(capacity_factor):
    """Output, lb_loss, z_loss and expert_load; at capacity factor 0.5 the
    capacity is 4 slots an expert for 32 choices, so choices are dropped."""
    x = _x()
    jm, params = _jax_moe(capacity_factor, x)
    y_j, aux_j = jm.apply(params, jnp.asarray(x))
    m = _port_moe(params, capacity_factor)
    y, aux = _run(m, x)
    np.testing.assert_allclose(y, np.asarray(y_j), **TOL)
    assert set(aux) == set(aux_j) == {"lb_loss", "z_loss", "expert_load"}
    for k in aux:
        np.testing.assert_allclose(aux[k], np.asarray(aux_j[k]), err_msg=k, **TOL)
    cap = tmoe.capacity(B * T, E, K, capacity_factor)
    dropped = int((tmoe.queue_slots(m.last_choice, E) >= cap).sum())
    assert (dropped > 0) == (capacity_factor < 1.0)
    if dropped:  # a dropped choice contributes nothing: the oracle differs
        assert np.abs(y - _oracle(params, x, m.last_choice.numpy())).max() > 1e-3
    else:
        np.testing.assert_allclose(y, _oracle(params, x, m.last_choice.numpy()), **TOL)


@pytest.mark.parametrize("tied", ["pairs", "all"])
def test_tied_router_probabilities_pick_the_experts_jax_picks(tied):
    """Router columns made equal so that probabilities tie exactly: both
    pick the lower expert index first (`jax.lax.top_k`; the port's stable
    sort), so outputs and loads agree."""
    x = _x(1)
    jm, params = _jax_moe(8.0, x)
    kernel = np.array(params["params"]["router"]["kernel"])
    if tied == "pairs":  # experts 2 and 3 copy experts 0 and 1
        kernel[:, 2:] = kernel[:, :2]
    else:
        kernel[:] = kernel[:, :1]
    params["params"]["router"]["kernel"] = kernel
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, D)) @ kernel, axis=-1)
    want_choice = np.asarray(jax.lax.top_k(probs, K)[1])
    m = _port_moe(params, 8.0)
    y, aux = _run(m, x)
    np.testing.assert_array_equal(m.last_choice.numpy(), want_choice)
    if tied == "all":
        assert (want_choice == [0, 1]).all()
    else:
        assert (want_choice < 2).any() and not (want_choice[:, 0] >= 2).any()
    y_j, aux_j = jm.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(y, np.asarray(y_j), **TOL)
    np.testing.assert_allclose(aux["expert_load"], np.asarray(aux_j["expert_load"]))


def test_bf16_matches_jax_while_no_expert_takes_more_than_256_choices():
    """bf16 inputs and parameters on both sides, 200 tokens over 4 experts
    (at most 256 choices an expert, where the JAX package's bf16 slot count
    is exact): the same experts chosen, output and aux at the bf16 bar."""
    x = _bf16(_x(2, b=2, t=100))
    jm, params = _jax_moe(2.0, x)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    y_j, aux_j = jm.apply(params, jnp.asarray(x, jnp.bfloat16))
    kernel = params["params"]["router"]["kernel"]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, D), jnp.bfloat16) @ kernel, axis=-1)
    want_choice = np.asarray(jax.lax.top_k(probs, K)[1])
    m = _port_moe(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), 2.0,
                  torch.bfloat16)
    y, aux = _run(m, x, torch.bfloat16)
    np.testing.assert_array_equal(m.last_choice.numpy(), want_choice)
    assert np.bincount(want_choice.ravel(), minlength=E).max() <= 256
    _bf16_close(y, np.asarray(y_j, np.float32), "y")
    for k in aux:
        _bf16_close(aux[k], np.asarray(aux_j[k], np.float32), k)


def test_bf16_past_256_choices_jax_shares_slots_and_the_port_does_not():
    """600 tokens that all choose expert 0 first, capacity for every choice.
    The JAX package's bf16 cumsum reads 256 twice and on, so tokens share an
    expert row and get each other's sum; the port counts slots in int64 and
    every token gets its own experts' output (the per-token oracle, at the
    bf16 bar).  The first 128 tokens agree between the two; in fp32 all do."""
    x = _x(3, b=2, t=300)
    x[..., 0] = 4.0
    jm, params = _jax_moe(4.0, x)
    kernel = np.array(params["params"]["router"]["kernel"])
    kernel[0, 0] = 3.0  # expert 0 leads everywhere
    params["params"]["router"]["kernel"] = kernel
    xb = _bf16(x)
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    y_j = np.asarray(jm.apply(pb, jnp.asarray(xb, jnp.bfloat16))[0], np.float32)
    m = _port_moe(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), pb), 4.0,
                  torch.bfloat16)
    y, _ = _run(m, xb, torch.bfloat16)
    choice = m.last_choice.numpy()
    assert (choice[:, 0] == 0).all() and np.bincount(choice.ravel(), minlength=E)[0] == 600
    oracle = _oracle(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), pb), xb,
                     choice)
    _bf16_close(y, oracle, "port vs oracle")
    scale = float(np.abs(oracle).max())
    assert np.abs(y_j - oracle).max() > 0.1 * scale  # JAX: shared slots
    _bf16_close(y.reshape(600, D)[:128], y_j.reshape(600, D)[:128], "first 128 tokens")
    # fp32: exact counts on both sides
    y32_j = np.asarray(jm.apply(params, jnp.asarray(x))[0])
    y32, _ = _run(_port_moe(params, 4.0), x)
    np.testing.assert_allclose(y32, y32_j, **TOL)


def test_route_override_replaces_the_choice_and_keeps_the_router_gates():
    x = _x(4)
    _, params = _jax_moe(8.0, x)
    m = _port_moe(params, 8.0)
    _run(m, x)
    own = m.last_choice.clone()
    forced = torch.flip(own, dims=[1]) % E
    forced[:, 1] = (forced[:, 0] + 1) % E
    m.route_override = forced
    y, _ = _run(m, x)
    assert torch.equal(m.last_choice, own)  # the router's own choice is still recorded
    np.testing.assert_allclose(y, _oracle(params, x, forced.numpy()), **TOL)


def test_expert_parallelism_raises_by_name():
    with pytest.raises(NotImplementedError, match="expert_shardings"):
        tmoe.expert_shardings({}, None)
    with pytest.raises(NotImplementedError, match="expert_axis"):
        tmoe.MoEMLP(8, expert_axis="expert")


# ---------------------------------------------------------------------------
# a Mixtral-shaped GPT
# ---------------------------------------------------------------------------

VOCAB, SEQ = 70, 24
N_STEPS = 3
OPTIM = {"name": "adamw", "lr": 3e-4, "weight_decay": 0.1, "betas": [0.9, 0.95],
         "sched": {"name": "CosineAnnealing", "warmup_ratio": 0.02, "min_lr": 3e-5,
                   "max_steps": 10}}


def _cfg(**extra):
    """Mixtral's family (8 experts, top 2, GQA, SwiGLU experts) at 2 layers
    and narrow widths, as the CLI builds it from `config_name`."""
    return {"config_name": "Mixtral-8x7B-v0.1", "n_layer": 2, "n_embd": 64, "n_head": 4,
            "n_query_groups": 2, "intermediate_size": 96, "vocab_size": VOCAB,
            "padding_multiple": 1, "block_size": SEQ, "use_flash": True, **extra}


def _batch_np():
    window = np.random.default_rng(0).integers(0, VOCAB, (3, SEQ + 1)).astype(np.int32)
    return {"input_ids": window[:, :-1], "labels": window[:, 1:]}


def _port_model(params, **extra):
    model = GPTLMModel(_cfg(**extra))
    convert.load_gpt_params(model.module, jax.device_get(params))
    return model


def _assert_tree_close(got, want, what, rtol, atol):
    got_flat, want_flat = flatten_dict(got), flatten_dict(jax.device_get(want))
    assert set(got_flat) == set(want_flat)
    for path, value in want_flat.items():
        np.testing.assert_allclose(got_flat[path], np.asarray(value), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")


@pytest.fixture(scope="module")
def jax_side():
    model = JaxGPTLMModel(_cfg())
    batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    params = model.init_params(jax.random.PRNGKey(0), batch)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, batch), has_aux=True))(params)
    out = {"params": jax.device_get(params), "metrics": {k: float(v) for k, v in
                                                          metrics.items()},
           "grads": jax.device_get(grads),
           "logits": np.asarray(model.module.apply(params, batch["input_ids"]))}

    def trajectory(precision):
        optimizer = jax_build_optimizer(OPTIM, gradient_clip_val=1.0)
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
    return out


def test_mixtral_registry_entry_builds_the_moe_mlp_at_full_width():
    """The registry's Mixtral at 2 layers, built on the meta device: 8
    experts of 14336, top 2, and the 3,164,688,384 parameters of the JAX
    package's entry at 2 layers."""
    config = tgpt.config_from_name("Mixtral-8x7B-v0.1", n_layer=2)
    with torch.device("meta"):
        model = tgpt.GPT(config)
    mlp = model.h[0].mlp
    assert isinstance(mlp, tmoe.MoEMLP)
    assert (mlp.n_experts, mlp.top_k, mlp.ff_dim) == (8, 2, 14336)
    assert tuple(mlp.w_down.shape) == (8, 14336, 4096)
    assert sum(p.numel() for p in model.parameters()) == 3_164_688_384


def test_converter_maps_the_moe_leaves_both_ways(jax_side):
    """Every leaf of the JAX tree, the router and the three expert weights
    included, fills the port and comes back unchanged, in both block
    layouts; a leaf the port does not consume raises."""
    params = jax_side["params"]
    model = _port_model(params)
    assert isinstance(model.module.h[1].mlp, tmoe.MoEMLP)
    back = convert.gpt_to_jax_tree(model.module)
    _assert_tree_close(back, params, "round trip", rtol=0, atol=0)
    leaves = flatten_dict(back["params"])
    assert ("h_0", "mlp", "router", "kernel") in leaves and ("h_1", "mlp", "w_down") in leaves
    stacked = convert.gpt_to_jax_tree(_port_model(params, scan_layers=True).module)
    assert stacked["params"]["h_scan"]["mlp"]["w_gate"].shape == (2, 8, 64, 96)
    again = convert.gpt_to_jax_tree(_port_model(stacked, scan_layers=True).module)
    _assert_tree_close(again, stacked, "stacked round trip", rtol=0, atol=0)
    extra = copy.deepcopy(params)
    extra["params"]["h_0"]["mlp"]["w_extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="not consumed"):
        _port_model(extra)


def test_logits_match_jax(jax_side):
    model = _port_model(jax_side["params"])
    with torch.no_grad():
        got = model.module(torch.from_numpy(_batch_np()["input_ids"]).long()).numpy()
    np.testing.assert_allclose(got, jax_side["logits"], **TOL)


def test_loss_and_every_gradient_match_jax_and_the_aux_is_kept_unread(jax_side):
    """The loss is the cross entropy alone (no lb / z term, as in the JAX
    task); each block keeps its newest aux."""
    model = _port_model(jax_side["params"])
    loss, metrics = model.loss_fn(to_device(_batch_np(), torch.device("cpu")))
    for k, v in jax_side["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **GPT_TOL)
    loss.backward()
    grads = copy.deepcopy(model.module)
    with torch.no_grad():
        for dst, src in zip(grads.parameters(), model.module.parameters()):
            dst.copy_(src.grad)
    want = jax_side["grads"]
    scale = max(float(np.abs(v).max()) for v in flatten_dict(want).values())
    _assert_tree_close(convert.gpt_to_jax_tree(grads), want, "grad", rtol=3e-3,
                       atol=3e-6 * scale)
    for block in model.module.h:
        assert set(block.moe_aux) == {"lb_loss", "z_loss", "expert_load"}
        assert all(torch.isfinite(v).all() for v in block.moe_aux.values())


@pytest.mark.parametrize("remat", [None, "nothing", "flash"])
def test_three_adamw_steps_follow_the_jax_trajectory(jax_side, remat):
    """Metrics per step and the parameters after three updates; under remat
    (either policy) the recomputed blocks route as the first pass did, so the
    trajectory is the same."""
    extra = {} if remat is None else {"remat": True, "remat_policy": remat, "scan_layers": True}
    model = _port_model(jax_side["params"], **extra)
    opt = build_optimizer(model.parameters(), OPTIM, gradient_clip_val=1.0)
    state = TrainState(model=model, opt=opt)
    batch = to_device(_batch_np(), torch.device("cpu"))
    for want in jax_side["trajectory"]:
        state, metrics = train_step(state, batch)
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **GPT_TOL)
    unrolled = convert.gpt_to_jax_tree(_port_model(convert.gpt_to_jax_tree(model.module)).module)
    _assert_tree_close(unrolled, jax_side["final"], "params", rtol=3e-3, atol=2e-4)


def test_bf16_steps_cast_the_experts_where_used_and_follow_jax_loosely(jax_side):
    """`precision="bf16"`: the expert weights stay fp32 masters with fp32
    gradients; the loss follows the JAX bf16 trajectory within 2e-2."""
    model = _port_model(jax_side["params"])
    opt = build_optimizer(model.parameters(), OPTIM, gradient_clip_val=1.0)
    trainer = Trainer(model=model, optimizer=opt, device="cpu", precision="bf16")
    state = trainer.init_state()
    batch = to_device(_batch_np(), torch.device("cpu"))
    for want in jax_side["trajectory_bf16"]:
        state, metrics = train_step(state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), want["loss"], atol=2e-2, rtol=0)
    mlp = model.module.h[0].mlp
    for p in (mlp.w_gate, mlp.w_up, mlp.w_down, mlp.router.weight):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    assert model.module.h[0].moe_aux["lb_loss"].dtype == torch.bfloat16
