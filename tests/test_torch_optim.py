"""Schedules and optimizers of the port against the JAX package (optax)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from roar_tpu.training import optim as jax_optim
from roar_tpu_torch.training import optim

LR, MAX_STEPS, WARMUP = 2e-3, 200, 20
SCHEDULE_KWARGS = {
    "ExponentialLR": {"gamma": 0.99, "min_lr": 1e-4},
    "StepLR": {"step_size": 30, "gamma": 0.5, "min_lr": 1e-5},
    "NoamAnnealing": {"d_model": 384, "warmup_steps": WARMUP, "min_lr": 1e-6},
    "CosineAnnealing": {"warmup_steps": WARMUP, "min_lr": 1e-5},
    "WarmupPolicy": {"warmup_steps": WARMUP, "min_lr": 1e-5},
    "WarmupHoldPolicy": {"warmup_steps": WARMUP},
    "SquareAnnealing": {"warmup_steps": WARMUP, "min_lr": 1e-5},
    "SquareRootAnnealing": {"warmup_steps": WARMUP, "min_lr": 1e-5},
    "InverseSquareRootAnnealing": {"warmup_steps": WARMUP, "min_lr": 1e-5},
    "PolynomialDecayAnnealing": {"warmup_steps": WARMUP, "min_lr": 1e-5, "power": 2.0},
    "NoamHoldAnnealing": {"warmup_steps": WARMUP, "hold_steps": 30, "decay_rate": 0.5,
                          "min_lr": 1e-5},
}
STEPS = [0, 1, WARMUP - 1, WARMUP, WARMUP + 1, 50, 51, 100, MAX_STEPS - 1, MAX_STEPS,
         MAX_STEPS + 50]


def test_every_jax_schedule_is_ported():
    assert set(optim._SCHEDULES) == set(jax_optim._SCHEDULES) == set(SCHEDULE_KWARGS)
    assert optim._SCHED_NEEDS_MAX_STEPS == jax_optim._SCHED_NEEDS_MAX_STEPS


@pytest.mark.parametrize("name", sorted(SCHEDULE_KWARGS))
def test_schedule_matches_jax(name):
    kwargs = SCHEDULE_KWARGS[name]
    want_fn = jax_optim.get_schedule(name, LR, max_steps=MAX_STEPS, **kwargs)
    got_fn = optim.get_schedule(name, LR, max_steps=MAX_STEPS, **kwargs)
    for step in STEPS:
        want = float(want_fn(jnp.asarray(step, jnp.int32)))
        # the JAX schedules compute in float32
        np.testing.assert_allclose(got_fn(step), want, rtol=2e-5, atol=1e-12,
                                   err_msg=f"{name} at {step}")


def test_warmup_ratio_and_its_errors():
    got = optim.get_schedule("CosineAnnealing", LR, max_steps=1000, warmup_ratio=0.02, min_lr=1e-5)
    want = jax_optim.get_schedule("CosineAnnealing", LR, max_steps=1000, warmup_ratio=0.02,
                                  min_lr=1e-5)
    for step in (0, 19, 20, 500):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-5)
    with pytest.raises(ValueError, match="not both"):
        optim.get_schedule("CosineAnnealing", LR, max_steps=10, warmup_ratio=0.1, warmup_steps=1)
    with pytest.raises(ValueError, match="needs max_steps"):
        optim.get_schedule("CosineAnnealing", LR)
    with pytest.raises(ValueError, match="Unknown scheduler"):
        optim.get_schedule("Linear", LR)


def _tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "c": rng.standard_normal((2, 3, 2)).astype(np.float32)}


OPTIM_CASES = {
    "adamw": {"name": "adamw", "lr": 2e-3, "betas": [0.8, 0.99]},
    "adamw_decay_sched": {"name": "adamw", "lr": 2e-3, "betas": [0.8, 0.99], "weight_decay": 0.1,
                          "sched": {"name": "CosineAnnealing", "warmup_steps": 2, "min_lr": 1e-5}},
    "adam": {"name": "adam", "lr": 1e-3},
    "adam_l2": {"name": "adam", "lr": 1e-3, "weight_decay": 0.05},
    "sgd": {"name": "sgd", "lr": 1e-2},
    "sgd_plain": {"name": "sgd", "lr": 1e-2, "momentum": 0.0},
    "adamw_clip": {"name": "adamw", "lr": 2e-3, "sched": {"name": "NoamAnnealing",
                                                           "warmup_steps": 3, "d_model": 4}},
}
# the same clip, handed the gradients' global norm the caller already holds
OPTIM_CASES["adamw_clip_given_norm"] = OPTIM_CASES["adamw_clip"]


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_five_updates_match_optax(case):
    cfg = OPTIM_CASES[case]
    clip = 0.5 if case.startswith("adamw_clip") else None
    rng = np.random.default_rng(0)
    params0 = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]

    opt = jax_optim.build_optimizer(cfg, max_steps=10, gradient_clip_val=clip)
    params = {k: jnp.asarray(v) for k, v in params0.items()}
    opt_state = opt.init(params)
    for g in grads:
        updates, opt_state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                        params)
        params = optax.apply_updates(params, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
    topt = optim.build_optimizer(tparams.values(), cfg, max_steps=10, gradient_clip_val=clip)
    for g in grads:
        topt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        if case == "adamw_clip_given_norm":
            topt.step(grad_norm=optim.global_norm(p.grad for p in tparams.values()))
        else:
            topt.step()
    assert topt.count == 5
    for k in params0:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(params[k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)


def test_defaults_first_update_and_state_round_trip():
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.build_optimizer([p], {"name": "adamw", "lr": 1e-2,
                                      "sched": {"name": "CosineAnnealing", "warmup_steps": 4}},
                                max_steps=10)
    assert opt.optimizer.defaults["weight_decay"] == 0.0  # not torch's 0.01
    assert opt.current_lr() == pytest.approx(1e-2 * 1 / 5)  # schedule(0), warm-up (step+1)/(w+1)
    p.grad = torch.ones(3)
    assert opt.step() == pytest.approx(2e-3)
    assert opt.current_lr() == pytest.approx(1e-2 * 2 / 5)
    saved = opt.state_dict()
    again = optim.build_optimizer([p], {"name": "adamw", "lr": 1e-2,
                                        "sched": {"name": "CosineAnnealing", "warmup_steps": 4}},
                                  max_steps=10)
    again.load_state_dict(saved)
    assert again.count == 1 and again.current_lr() == opt.current_lr()
    with pytest.raises(NotImplementedError, match="not ported"):
        optim.get_optimizer("rmsprop", [p], 1e-3)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        optim.get_optimizer("lion", [p], 1e-3)
