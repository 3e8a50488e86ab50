"""Dynamic freezing (`freeze_updates`) of the port's trainer against the JAX
package's `Trainer(freeze_updates=...)`, on the CPU.

A narrow FastPitch (2 + 2 layers, d_model 64; every dropout rate 0, the JAX
side deterministic) takes 6 AdamW updates on one batch from the same
weights, for each schedule form: scalar N, a window, -1, an open end, the
longest of two matching names, and a window under gradient accumulation.
After every update the parameters and Adam's moments are held to the JAX
side's at rtol 3e-3, the first update after each window included (the port
bias-corrects it at the shared count, as optax does), and a frozen
parameter is bit-identical to its value when the window began.
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roar_tpu.models.fastpitch_model import FastPitchModel as JaxFastPitchModel
from roar_tpu.training.optim import build_optimizer as jax_build_optimizer
from roar_tpu.training.trainer import Trainer as JaxTrainer
from roar_tpu_torch.models.fastpitch_model import FastPitchModel
from roar_tpu_torch.training import convert
from roar_tpu_torch.training.optim import build_optimizer
from roar_tpu_torch.training.trainer import FreezeSchedule, Trainer, freeze_flag, train_step

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fastpitch_train import EPOCH, OPTIM, _batch_np, _cfg, _torch_batch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

N_UPDATES = 6
RTOL = 3e-3
CASES = {
    "scalar": ({"aligner_module": 2}, 1),
    "window": ({"decoder_module/layers_0": [2, 3]}, 1),
    "forever": ({"duration_predictor_module": -1}, 1),
    "open_end": ({"pitch_predictor_module": [3, -1]}, 1),
    "longest_match": ({"decoder_module": 2, "decoder_module/layers_0": [3, 4]}, 1),
    "accumulate": ({"encoder_module": [2, 3]}, 2),
}


PATHS = convert.fastpitch_flax_paths(FastPitchModel(_cfg()).module)


@pytest.fixture(scope="module")
def start():
    model = JaxFastPitchModel(_cfg(dropout=0.0, dropatt=0.0))
    batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    return model, batch, jax.device_get(model.init_params(jax.random.PRNGKey(0), batch))


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))


def _flat(tree):
    return convert.flatten_params(jax.device_get(tree))


def _jax_run(start, modules, k):
    """[(params, mu, nu, count, grad_norm)] after each of N_UPDATES updates."""
    model, batch, params = start
    trainer = JaxTrainer(
        loss_fn=lambda p, b, rng, epoch: model.loss_fn(p, b, None, epoch, deterministic=True),
        optimizer=jax_build_optimizer(OPTIM), accumulate_grad_batches=k,
        freeze_updates={"enabled": True, "modules": modules})
    state = trainer.init_state(jax.tree_util.tree_map(jnp.array, params))
    out = []
    for i in range(N_UPDATES * k):
        state, metrics = trainer._train_step(state, batch, jax.random.PRNGKey(0), EPOCH)
        if (i + 1) % k == 0:
            adam = _adam_state(state.opt_state)
            out.append((_flat(state.params), _flat(adam.mu), _flat(adam.nu), int(adam.count),
                        float(metrics["grad_norm"])))
    return out


def _port_run(start, modules, k):
    _, _, params = start
    model = FastPitchModel(_cfg(dropout=0.0, dropatt=0.0))
    convert.load_fastpitch_params(model.module, params)
    trainer = Trainer(model, build_optimizer(model.parameters(), OPTIM), device="cpu",
                      accumulate_grad_batches=k,
                      freeze_updates={"enabled": True, "modules": modules})
    state = trainer.init_state()
    batch = _torch_batch()
    out = []
    for i in range(N_UPDATES * k):
        state, metrics = train_step(state, batch, EPOCH, k)
        if (i + 1) % k == 0:
            opt_state = state.opt.optimizer.state
            moments = [_as_flax(model, lambda p: opt_state[p][key] if p in opt_state
                                else torch.zeros_like(p))
                       for key in ("exp_avg", "exp_avg_sq")]
            out.append((_as_flax(model, lambda p: p), *moments, state.opt.count,
                        float(metrics["grad_norm"])))
    return out, trainer.freeze


def _as_flax(model, value_of):
    """{flax path: array} of `value_of(parameter)` for every parameter, in
    the flax layouts."""
    holder = copy.deepcopy(model.module)
    with torch.no_grad():
        for dst, src in zip(holder.parameters(), model.module.parameters()):
            dst.copy_(value_of(src))
    return convert.flatten_params(convert.fastpitch_to_jax_tree(holder))


def _key_bias_free(path, value):
    """A qkv bias without its key third: that third's gradient is rounding
    only (softmax ignores a per-row constant), so Adam moves it by the sign
    of noise."""
    if path.endswith("qkv_net/bias"):
        third = value.shape[0] // 3
        return np.delete(value, np.s_[third:2 * third])
    return value


def _scale(tree):
    return max(float(np.abs(np.asarray(v)).max()) for v in tree.values())


def _close(got, want, what, scale_atol):
    assert set(got) == set(want), what
    for path, w in want.items():
        g, w = _key_bias_free(path, got[path]), _key_bias_free(path, np.asarray(w))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=scale_atol, err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_freeze_schedule_follows_jax_every_update(start, case):
    modules, k = CASES[case]
    want = _jax_run(start, modules, k)
    got, schedule = _port_run(start, modules, k)
    params0 = convert.flatten_params(start[2])
    frozen_any = False
    for update, ((gp, gm, gv, gc, gn), (wp, wm, wv, wc, wn)) in enumerate(zip(got, want), 1):
        assert gc == wc == update  # the shared count goes on through every window
        np.testing.assert_allclose(gn, wn, rtol=RTOL, err_msg=f"grad_norm at update {update}")
        _close(gp, wp, f"params after update {update}", 2e-4)
        # a moment's small entries carry the rounding of its large ones, and
        # by update 6 that of five earlier updates: atol 3e-5 of the tree's
        # largest entry
        _close(gm, wm, f"mu after update {update}", 3e-5 * _scale(wm))
        _close(gv, wv, f"nu after update {update}", 3e-5 * _scale(wv))
        # a parameter frozen at this update is where it was before it
        frozen = {PATHS[n] for n in schedule.frozen(update)}
        before = params0 if update == 1 else got[update - 2][0]
        before_w = params0 if update == 1 else want[update - 2][0]
        for path in frozen:
            frozen_any = True
            assert np.array_equal(gp[path], before[path]), f"port moved frozen {path}"
            assert np.array_equal(np.asarray(wp[path]), np.asarray(before_w[path])), path
    assert frozen_any
    # each frozen module moves again once its window has passed (-1: never)
    last = got[-1][0]
    for name, spec in schedule.specs.items():
        path = PATHS[name]
        moved = not np.array_equal(last[path], params0[path])
        assert moved == (spec != -1), (name, spec)


def test_flag_semantics():
    assert [freeze_flag(u, 2) for u in (1, 2, 3)] == [True, True, False]
    assert all(freeze_flag(u, -1) for u in (1, 100))
    assert [freeze_flag(u, [2, 3]) for u in (1, 2, 3, 4)] == [False, True, True, False]
    assert [freeze_flag(u, [3, -1]) for u in (2, 3, 1000)] == [False, True, True]


def test_longest_name_wins_and_matches_whole_components():
    paths = {"a": "params/decoder_module/layers_0/pos_ff/Conv_0/kernel",
             "b": "params/decoder_module/layers_1/pos_ff/Conv_0/kernel",
             "c": "params/aligner_module/key_proj_0/Conv_0/kernel"}
    schedule = FreezeSchedule({"decoder_module": 2, "decoder_module/layers_0": [3, 4],
                               "Conv_0": -1}, paths)
    assert schedule.specs == {"a": [3, 4], "b": 2, "c": -1}
    with pytest.raises(ValueError, match="matches no parameter path"):
        FreezeSchedule({"key_proj": 1}, paths)  # not a whole component


def test_bad_schedules_raise_on_both_sides(start):
    model = FastPitchModel(_cfg())
    opt = build_optimizer(model.parameters(), OPTIM)
    for modules, match in (({"aligner_module": [1, 2, 3]}, "more than two elements"),
                           ({"no_such_module": 1}, "matches no parameter path.*params")):
        with pytest.raises(ValueError, match=match):
            Trainer(model, opt, device="cpu", freeze_updates={"enabled": True,
                                                              "modules": modules})
        jax_model, batch, params = start
        trainer = JaxTrainer(
            loss_fn=lambda p, b, rng, e: jax_model.loss_fn(p, b, None, e, deterministic=True),
            optimizer=jax_build_optimizer(OPTIM),
            freeze_updates={"enabled": True, "modules": modules})
        state = trainer.init_state(jax.tree_util.tree_map(jnp.array, params))
        with pytest.raises(ValueError, match=match):
            trainer._train_step(state, batch, jax.random.PRNGKey(0), EPOCH)


def test_disabled_or_empty_freezing_is_inert():
    model = FastPitchModel(_cfg())
    opt = build_optimizer(model.parameters(), OPTIM)
    for spec in ({"modules": {"no_such_module": 1}}, {"enabled": False, "modules": {"x": 1}},
                 {"enabled": True, "modules": {}}):
        trainer = Trainer(model, opt, device="cpu", freeze_updates=spec)
        assert trainer.freeze is None and not opt.shared_count
    frozen = copy.deepcopy(model)
    with pytest.raises(NotImplementedError, match="flax_paths"):
        class NoPaths:
            module = frozen.module
        Trainer(NoPaths(), opt, device="cpu",
                freeze_updates={"enabled": True, "modules": {"aligner_module": 1}})
