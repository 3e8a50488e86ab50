"""Optimizer and LR-schedule registries.

Port of roar_tpu/training/optim.py (optax) onto torch.optim.  The schedules
are the same closed forms, written as plain functions of the step.  What
differs between the two libraries and is matched here:

- optax reads the schedule at the number of updates done so far, so the
  first update uses `schedule(0)`; `ScheduledOptimizer.step` sets the
  learning rate that way before every update;
- `weight_decay` defaults to 0.0 (torch.optim.AdamW's own default is 0.01);
- `adam` with weight decay is L2 regularisation added to the gradient;
- gradient clipping is optax's `clip_by_global_norm`: gradients are scaled
  by max_norm / norm only when norm >= max_norm, with no epsilon;
- adadelta, adamax, adagrad and rmsprop are optax's update rules, written
  here (`Adadelta`, `Adamax`, `Adagrad`, `RMSprop`): torch.optim's classes of
  those names start, scale or guard differently (adagrad's accumulator
  starts at 0.1 and its eps sits inside the root; rmsprop decays by 0.9,
  keeps eps inside the root and takes momentum on the learning-rate-scaled
  update);
- under dynamic freezing (`ScheduledOptimizer.shared_count`) every update
  counts once for every parameter, as optax's one `count` does: a parameter
  that sat out some updates is bias-corrected at the shared count when it
  moves again.

Optimizers: sgd, adam, adamw, adadelta, adamax, adagrad, rmsprop.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional

import torch

Schedule = Callable[[int], float]


def _warm(initial_lr: float, step: float, warmup_steps: int) -> float:
    return initial_lr * (step + 1.0) / max(warmup_steps + 1, 1)


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def noam_annealing(initial_lr: float, d_model: int = 1, warmup_steps: int = 1000,
                   min_lr: float = 0.0) -> Schedule:
    norm = d_model ** (-0.5)

    def schedule(step):
        s = max(float(step + 1), 1.0)  # the schedule counts from 1
        lr = initial_lr * norm * min(s ** -0.5, s * (warmup_steps ** -1.5))
        return max(lr, min_lr)

    return schedule


def cosine_annealing(initial_lr: float, max_steps: int, warmup_steps: int = 0,
                     min_lr: float = 0.0) -> Schedule:
    def schedule(step):
        if step < warmup_steps:
            return _warm(initial_lr, step, warmup_steps)
        progress = _clip01((step - warmup_steps) / max(max_steps - warmup_steps, 1))
        return min_lr + (initial_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule


def warmup_policy(initial_lr, max_steps, warmup_steps=0, min_lr=0.0) -> Schedule:
    def schedule(step):
        if step < warmup_steps:
            return _warm(initial_lr, step, warmup_steps)
        return max(initial_lr, min_lr)

    return schedule


def square_annealing(initial_lr, max_steps, warmup_steps=0, min_lr=0.0) -> Schedule:
    def schedule(step):
        if step < warmup_steps:
            return _warm(initial_lr, step, warmup_steps)
        mult = _clip01((max_steps - step) / max(max_steps - warmup_steps, 1)) ** 2
        return (initial_lr - min_lr) * mult + min_lr

    return schedule


def square_root_annealing(initial_lr, max_steps, warmup_steps=0, min_lr=0.0) -> Schedule:
    def schedule(step):
        if step < warmup_steps:
            return _warm(initial_lr, step, warmup_steps)
        mult = math.sqrt(_clip01((max_steps - step) / max(max_steps - warmup_steps, 1)))
        return max(initial_lr * mult, min_lr)

    return schedule


def inverse_square_root_annealing(initial_lr, max_steps, warmup_steps=0, min_lr=0.0) -> Schedule:
    def schedule(step):
        if step < warmup_steps:
            return _warm(initial_lr, step, warmup_steps)
        denom = math.sqrt(max((step + 1.0) / max(warmup_steps + 1, 1), 1.0))
        return max(initial_lr / denom, min_lr)

    return schedule


def polynomial_decay_annealing(initial_lr, max_steps, warmup_steps=0, min_lr=0.0, power=1.0,
                               cycle=False) -> Schedule:
    def schedule(step):
        if step < warmup_steps:
            return _warm(initial_lr, step, warmup_steps)
        p = _clip01((step - warmup_steps) / max(max_steps - warmup_steps, 1))
        return (initial_lr - min_lr) * (1.0 - p) ** power + min_lr

    return schedule


def noam_hold_annealing(initial_lr, max_steps, warmup_steps=0, hold_steps=0, decay_rate=0.5,
                        min_lr=0.0) -> Schedule:
    def schedule(step):
        hold_until = warmup_steps + hold_steps
        if step > hold_until:
            return max(initial_lr * (hold_until / max(float(step), 1.0)) ** decay_rate, min_lr)
        if step < warmup_steps:
            return _warm(initial_lr, step, warmup_steps)
        return initial_lr

    return schedule


def exponential_lr(initial_lr, max_steps=None, gamma=0.999, min_lr=0.0) -> Schedule:
    return lambda step: max(initial_lr * gamma ** step, min_lr)


def step_lr(initial_lr, max_steps=None, step_size=1000, gamma=0.1, min_lr=0.0) -> Schedule:
    return lambda step: max(initial_lr * gamma ** math.floor(step / step_size), min_lr)


_SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "ExponentialLR": exponential_lr,
    "StepLR": step_lr,
    "NoamAnnealing": noam_annealing,
    "CosineAnnealing": cosine_annealing,
    "WarmupPolicy": warmup_policy,
    "WarmupHoldPolicy": warmup_policy,
    "SquareAnnealing": square_annealing,
    "SquareRootAnnealing": square_root_annealing,
    "InverseSquareRootAnnealing": inverse_square_root_annealing,
    "PolynomialDecayAnnealing": polynomial_decay_annealing,
    "NoamHoldAnnealing": noam_hold_annealing,
}

_SCHED_NEEDS_MAX_STEPS = {
    "CosineAnnealing", "WarmupPolicy", "WarmupHoldPolicy", "SquareAnnealing",
    "SquareRootAnnealing", "InverseSquareRootAnnealing", "PolynomialDecayAnnealing",
    "NoamHoldAnnealing",
}


def compute_max_steps(max_epochs: int, steps_per_epoch: int,
                      accumulate_grad_batches: int = 1) -> int:
    return math.ceil(steps_per_epoch / max(accumulate_grad_batches, 1)) * max_epochs


def get_schedule(name: str, initial_lr: float, max_steps: Optional[int] = None,
                 **kwargs) -> Schedule:
    if name not in _SCHEDULES:
        raise ValueError(f"Unknown scheduler {name!r}; options: {sorted(_SCHEDULES)}")
    kwargs = dict(kwargs)
    kwargs.pop("name", None)
    kwargs.pop("last_epoch", None)
    if name in _SCHED_NEEDS_MAX_STEPS:
        if max_steps is None:
            raise ValueError(f"{name} needs max_steps")
        kwargs.setdefault("max_steps", max_steps)
    # warmup_ratio is a fraction of max_steps, exclusive with warmup_steps
    ratio = kwargs.pop("warmup_ratio", None)
    if ratio is not None:
        if kwargs.get("warmup_steps") is not None:
            raise ValueError("pass either warmup_steps or warmup_ratio, not both")
        if max_steps is None:
            raise ValueError("warmup_ratio needs max_steps")
        kwargs["warmup_steps"] = int(float(ratio) * max_steps)
    return _SCHEDULES[name](initial_lr=initial_lr, **kwargs)


class _OptaxRule(torch.optim.Optimizer):
    """A torch optimizer whose `step` applies one optax update rule to every
    parameter that has a gradient; `lr` is the group's learning rate."""

    def init_state(self, p: torch.Tensor) -> dict:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self.init_state(p))
                self.update(p, p.grad, state, group)
        return None


class Adadelta(_OptaxRule):
    """optax.adadelta(lr): e_g <- rho e_g + (1 - rho) g^2;
    d = sqrt(e_x + eps) / sqrt(e_g + eps) * g; e_x <- rho e_x + (1 - rho) d^2;
    p <- p - lr d."""

    def __init__(self, params, lr: float, rho: float = 0.9, eps: float = 1e-6):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps))

    def init_state(self, p):
        return {"e_g": torch.zeros_like(p), "e_x": torch.zeros_like(p)}

    def update(self, p, g, state, group):
        rho, eps = group["rho"], group["eps"]
        state["e_g"].mul_(rho).add_((1 - rho) * g * g)
        d = torch.sqrt(state["e_x"] + eps) / torch.sqrt(state["e_g"] + eps) * g
        state["e_x"].mul_(rho).add_((1 - rho) * d * d)
        p.sub_(group["lr"] * d)


class Adagrad(_OptaxRule):
    """optax.adagrad(lr): the sum of squares starts at 0.1;
    p <- p - lr g / sqrt(sum + 1e-7) (0 where the sum is 0)."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    def init_state(self, p):
        return {"sum_of_squares": torch.full_like(p, self.defaults["initial_accumulator_value"])}

    def update(self, p, g, state, group):
        acc = state["sum_of_squares"]
        acc.add_(g * g)
        scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), torch.zeros_like(acc))
        p.sub_(group["lr"] * (scale * g))


class RMSprop(_OptaxRule):
    """optax.rmsprop(lr, momentum=m, eps=eps): nu <- 0.9 nu + 0.1 g^2 (from 0);
    u = -lr g / sqrt(nu + eps); with momentum, trace <- u + m trace and
    p <- p + trace; without, p <- p + u."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 momentum: Optional[float] = None):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    def init_state(self, p):
        state = {"nu": torch.zeros_like(p)}
        if self.defaults["momentum"] is not None:
            state["trace"] = torch.zeros_like(p)
        return state

    def update(self, p, g, state, group):
        decay = group["decay"]
        state["nu"].mul_(decay).add_((1 - decay) * g * g)
        u = -group["lr"] * (torch.rsqrt(state["nu"] + group["eps"]) * g)
        if group["momentum"] is not None:
            u = state["trace"].mul_(group["momentum"]).add_(u)
        p.add_(u)


class Adamax(_OptaxRule):
    """optax.adamax(lr, b1, b2, eps): mu <- b1 mu + (1 - b1) g;
    nu <- max(|g| + eps, b2 nu); p <- p - lr (mu / (1 - b1^count)) / nu, the
    count taken after this update."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    def init_state(self, p):
        return {"step": torch.tensor(0.0), "mu": torch.zeros_like(p),
                "nu": torch.zeros_like(p)}

    def update(self, p, g, state, group):
        b1, b2 = group["betas"]
        state["step"] += 1
        state["mu"].mul_(b1).add_((1 - b1) * g)
        torch.maximum(g.abs() + group["eps"], b2 * state["nu"], out=state["nu"])
        correction = 1 - b1 ** float(state["step"])
        p.sub_(group["lr"] * ((state["mu"] / correction) / state["nu"]))


def _init_adam_state(optimizer: torch.optim.Optimizer, group: dict, p: torch.Tensor) -> dict:
    """The empty state torch.optim.Adam / AdamW give a parameter at its first
    update, filled in before it so that its step can be set."""
    on_device = group.get("capturable") or group.get("fused")
    state = {"step": torch.tensor(0.0, dtype=torch.float32,
                                  device=p.device if on_device else None),
             "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
             "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
    if group.get("amsgrad"):
        state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state


def get_optimizer(name: str, params: Iterable[torch.nn.Parameter], learning_rate: float,
                  betas=(0.9, 0.999), weight_decay: float = 0.0, eps: float = 1e-8,
                  momentum: float = 0.9, **_unused) -> torch.optim.Optimizer:
    name = name.lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum or 0.0)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas), eps=eps,
                                weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=tuple(betas), eps=eps,
                                 weight_decay=weight_decay)
    # as the JAX registry: adadelta and adagrad take only the learning rate
    if name == "adadelta":
        return Adadelta(params, lr=learning_rate)
    if name == "adamax":
        return Adamax(params, lr=learning_rate, betas=tuple(betas), eps=eps)
    if name == "adagrad":
        return Adagrad(params, lr=learning_rate)
    if name == "rmsprop":
        return RMSprop(params, lr=learning_rate, eps=eps, momentum=momentum)
    raise ValueError(f"Unknown optimizer {name!r}")


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax `global_norm`: the L2 norm of all the tensors taken as one vector."""
    return torch.sqrt(sum((t.detach() ** 2).sum() for t in tensors))


def clip_by_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax `clip_by_global_norm` on the `.grad`s, in place; returns the
    norm.  `norm`, when the caller has it already, is the global norm of
    those gradients and is not computed again."""
    grads = [p.grad for p in params if p.grad is not None]
    if norm is None:
        norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)
    return norm


class ScheduledOptimizer:
    """A torch optimizer with its schedule and clip: `step()` sets the
    learning rate to `schedule(updates done so far)`, clips, and updates."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Optional[Schedule],
                 base_lr: float, gradient_clip_val: Optional[float] = None):
        self.optimizer = optimizer
        self.schedule = schedule
        self.base_lr = base_lr
        self.gradient_clip_val = gradient_clip_val
        self.count = 0
        # set under dynamic freezing: a parameter without a `.grad` sits out
        # an update, and its own step is then set to `count` before the next
        # one it takes part in (optax's shared count)
        self.shared_count = False

    @property
    def params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def current_lr(self) -> float:
        """The learning rate the next update will use."""
        return float(self.schedule(self.count)) if self.schedule else self.base_lr

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> float:
        """One update; `grad_norm` is the global norm of the `.grad`s where
        the caller has computed it (the clip then reuses it)."""
        lr = self.current_lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        if self.gradient_clip_val:
            clip_by_global_norm(self.params, self.gradient_clip_val, norm=grad_norm)
        if self.shared_count:
            self._share_count()
        self.optimizer.step()
        self.count += 1
        return lr

    def _share_count(self) -> None:
        """Set the step of every parameter about to be updated to the number
        of updates done so far (the optimizer adds one, as optax's count
        does); a parameter that has not moved yet gets its empty state now."""
        opt = self.optimizer
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = opt.state[p]
                if not state and self.count:
                    if isinstance(opt, _OptaxRule):
                        state.update(opt.init_state(p))
                    elif isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
                        state.update(_init_adam_state(opt, group, p))
                if "step" in state:
                    state["step"] = torch.full_like(state["step"], float(self.count))

    def state_dict(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def build_optimizer(params: Iterable[torch.nn.Parameter], optim_cfg: Dict[str, Any],
                    steps_per_epoch: Optional[int] = None, max_epochs: Optional[int] = None,
                    max_steps: Optional[int] = None,
                    gradient_clip_val: Optional[float] = None) -> ScheduledOptimizer:
    """Optimizer (+schedule, +clip) over `params` from an optim config:
    {name, lr, betas, weight_decay, sched: {name, warmup_steps, ...}}."""
    cfg = dict(optim_cfg or {})
    cfg.pop("_target_", None)
    sched_cfg = cfg.pop("sched", None)
    name = cfg.pop("name", "adamw")
    lr = float(cfg.pop("lr", 1e-3))
    for k in ("weight_decay", "eps", "momentum"):
        if k in cfg:
            cfg[k] = float(cfg[k])
    if "betas" in cfg:
        cfg["betas"] = tuple(float(x) for x in cfg["betas"])

    schedule = None
    if sched_cfg:
        sc = dict(sched_cfg)
        sname = sc.pop("name")
        if max_steps is None and sc.get("max_steps") is not None:
            max_steps = sc.pop("max_steps")
        else:
            sc.pop("max_steps", None)
        if max_steps is None and steps_per_epoch is not None and max_epochs is not None:
            max_steps = compute_max_steps(max_epochs, steps_per_epoch)
        if sc.get("warmup_ratio") is not None:
            if max_steps is None:
                raise ValueError("warmup_ratio requires max_steps to be resolvable")
            sc["warmup_steps"] = int(float(sc.pop("warmup_ratio")) * max_steps)
        else:
            sc.pop("warmup_ratio", None)
        for k in ("min_lr", "decay_rate", "power"):
            if k in sc:
                sc[k] = float(sc[k])
        schedule = get_schedule(sname, initial_lr=lr, max_steps=max_steps, **sc)

    return ScheduledOptimizer(get_optimizer(name, list(params), lr, **cfg), schedule, lr,
                              gradient_clip_val)
