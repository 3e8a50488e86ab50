"""Training engine for loss_fn-style tasks: the supervised step and epoch loop.

Port of roar_tpu/training/trainer.py:128-393 to eager PyTorch on one device.
A task is an object with `module` (an `nn.Module` holding every parameter),
`loss_fn(batch, epoch, mark=None) -> (loss, metrics)` and
`set_dropout_generator(generator)` (every random draw of a training-mode
forward); `models/fastpitch_model.py::FastPitchModel`
and `models/gpt_model.py::GPTLMModel` are two.  One step: forward in training
mode, backward, `grad_norm` of this batch's gradients, then (every
`accumulate_grad_batches` steps, on the mean of the gradients since the last
update, as `optax.MultiSteps` does) the global-norm clip and the optimizer
update of `optim.ScheduledOptimizer`.  Metrics stay tensors on the device: the
host waits for the device only where it logs.

Dynamic freezing (`freeze_updates`, roar_tpu/training/trainer.py:74-125 and
153-227): `{"enabled": true, "modules": {name: N | [start, end]}}`.  A name
matches a parameter when its '/'-separated parts are a contiguous run of the
parameter's flax path (the task's `flax_paths()`); the longest match wins, and
a name that matches nothing raises.  Scalar N freezes while the update number
(`step // accumulate_grad_batches + 1`) is <= N, -1 for ever; [start, end]
inside the window, `end == -1` leaving it open.  A frozen parameter gets no
`.grad` for that update, so the optimizer leaves it and its state alone, and
its gradient is left out of `grad_norm` and of the clip; the optimizer's
count goes on for all (`ScheduledOptimizer.shared_count`).  A task may hold
parameters its optimizer does not (`finetune.masked_optimizer`): their
gradients are computed and counted in `grad_norm`, as the JAX step takes the
norm before `optax.multi_transform` zeroes them, and they never move.

`precision="bf16"` is what roar_tpu/training/trainer.py:152-174 does: the
parameters and the optimizer state stay fp32, forward and backward run on a
bf16 cast of the parameters and of the batch's floating tensors, and the
gradients come back in fp32.  A task takes it by declaring
`set_compute_dtype(dtype)` (`GPTLMModel` and `FastPitchModel` do); for any
other task it raises `NotImplementedError`.

`Trainer.callbacks` are called as `cb(state, metrics)` after every step.

Not ported: tensor-parallel rules and the device mesh; each raises
`NotImplementedError`.  There is no EMA of the parameters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from roar_tpu_torch.training.optim import ScheduledOptimizer, global_norm


def to_device(batch: Dict[str, Any], device: torch.device,
              float_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on `device`; with `float_dtype`, its
    floating tensors in that type."""
    out = {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
           for k, v in batch.items() if not isinstance(v, (str, list, tuple))}
    if float_dtype is not None:
        out = {k: v.to(float_dtype) if v.is_floating_point() else v for k, v in out.items()}
    return out


def freeze_flag(update: int, spec) -> bool:
    """Is a module with schedule `spec` frozen at (1-based) `update`?"""
    if isinstance(spec, (list, tuple)):
        start, end = spec
        return start <= update and (update <= end or end == -1)
    return update <= spec or spec == -1


class FreezeSchedule:
    """Which parameters sit out which updates (the JAX `_freeze_specs`):
    `modules` maps a '/'-joined module name to N or [start, end];
    `flax_paths` maps each parameter name to its flax path."""

    def __init__(self, modules: Dict[str, Any], flax_paths: Dict[str, str]):
        for name, spec in modules.items():
            if isinstance(spec, (list, tuple)) and len(spec) != 2:
                raise ValueError(
                    f"freeze_updates modules list cannot have more than two elements "
                    f"({name}: {list(spec)})")
        paths = {name: tuple(path.split("/")) for name, path in flax_paths.items()}
        parts = {name: tuple(name.split("/")) for name in modules}

        def matches(name_parts, path):
            n = len(name_parts)
            return any(path[i:i + n] == name_parts for i in range(len(path) - n + 1))

        for name, name_parts in parts.items():
            if not any(matches(name_parts, p) for p in paths.values()):
                raise ValueError(
                    f"freeze_updates module '{name}' matches no parameter path; "
                    f"top-level params: {sorted({p[0] for p in paths.values()})}")
        self.specs: Dict[str, Any] = {}
        for pname, path in paths.items():
            best, best_len = None, -1
            for name, name_parts in parts.items():
                if len(name_parts) > best_len and matches(name_parts, path):
                    best, best_len = modules[name], len(name_parts)
            if best is not None:
                self.specs[pname] = best

    def frozen(self, update: int) -> set:
        """Names of the parameters frozen at `update`."""
        return {name for name, spec in self.specs.items() if freeze_flag(update, spec)}


@dataclasses.dataclass
class TrainState:
    """What a supervised run carries from step to step.  `step` counts
    batches (micro-batches under gradient accumulation), as the JAX
    package's TrainState does; `dropout_generator` draws the dropout masks."""

    model: Any
    opt: ScheduledOptimizer
    step: int = 0
    dropout_generator: Optional[torch.Generator] = None
    freeze: Optional[FreezeSchedule] = None

    def state_dict(self) -> Dict[str, Any]:
        state = {"step": self.step, "module": self.model.module.state_dict(),
                 "opt": self.opt.state_dict()}
        if self.dropout_generator is not None:
            state["dropout_rng"] = self.dropout_generator.get_state()
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.model.module.load_state_dict(state["module"])
        self.opt.load_state_dict(state["opt"])
        if self.dropout_generator is not None and "dropout_rng" in state:
            self.dropout_generator.set_state(state["dropout_rng"].cpu())


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], epoch: int = 0,
               accumulate_grad_batches: int = 1,
               mark: Optional[Callable[[str], None]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One supervised step on `batch` (tensors on the module's device);
    returns the state and the step's metrics as tensors (nothing is
    synchronised).  `mark(name)` is a profiling hook and nothing else: when
    given, it is called as each part has been enqueued (the task's own marks,
    then "backward" and "optimizer"), so a timer can record an event there."""
    model, opt = state.model, state.opt
    mark = mark or (lambda name: None)
    model.module.train()
    loss, metrics = model.loss_fn(batch, epoch, mark=mark)
    named = list(model.module.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    # a parameter the loss does not reach has a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]
    mark("backward")

    k = max(int(accumulate_grad_batches), 1)
    frozen = state.freeze.frozen(state.step // k + 1) if state.freeze is not None else set()
    metrics["grad_norm"] = global_norm(
        [g for (name, _), g in zip(named, grads) if name not in frozen])
    updated = {id(p) for p in opt.params}
    first_of_group = state.step % k == 0
    for (name, p), g in zip(named, grads):
        if id(p) not in updated:
            continue
        if name in frozen:  # the window holds for the whole group
            p.grad = None
            continue
        if k > 1:
            g = g / k
        p.grad = g if first_of_group else p.grad + g
    state.step += 1
    if state.step % k == 0:
        # without accumulation, and with every parameter the norm counts in
        # the optimizer, the `.grad`s are the ones `grad_norm` measured: the
        # clip reuses it
        same = k == 1 and len(updated) == len(named)
        opt.step(grad_norm=metrics["grad_norm"] if same else None)
    mark("optimizer")
    return state, metrics


@dataclasses.dataclass
class Trainer:
    """Epoch and step loop over numpy batches for one task on one device."""

    model: Any
    optimizer: ScheduledOptimizer
    device: Any = "cuda"
    seed: int = 0
    log_every: int = 50
    precision: Optional[str] = None
    accumulate_grad_batches: int = 1
    # training halts once the step count reaches it, even mid-epoch; counted
    # on the host
    max_steps: Optional[int] = None
    freeze_updates: Optional[Dict[str, Any]] = None
    tp_rules: Optional[Any] = None
    mesh: Optional[Any] = None
    callbacks: Tuple = ()

    def __post_init__(self):
        self.compute_dtype = None
        if self.precision in ("bf16", "bfloat16", "bf16-mixed"):
            if not hasattr(self.model, "set_compute_dtype"):
                raise NotImplementedError(
                    f"precision=bf16 (bf16 compute with fp32 master weights) is not ported for "
                    f"{type(self.model).__name__}; train in fp32")
            self.compute_dtype = torch.bfloat16
        self.freeze = None
        if self.freeze_updates and self.freeze_updates.get("enabled", False):
            modules = dict(self.freeze_updates.get("modules") or {})
            if modules:
                if not hasattr(self.model, "flax_paths"):
                    raise NotImplementedError(
                        f"freeze_updates needs the task's flax paths; "
                        f"{type(self.model).__name__} has no `flax_paths()`")
                self.freeze = FreezeSchedule(modules, self.model.flax_paths())
                self.optimizer.shared_count = True
        if self.tp_rules is not None or self.mesh is not None:
            raise NotImplementedError("tensor-parallel rules and device meshes are not ported: "
                                      "the port trains on one device")
        self.device = torch.device(self.device)
        self.reached_max_steps = False

    def init_state(self) -> TrainState:
        """Move the task to the device and start the dropout generator there."""
        self.model.module.to(self.device)
        if self.compute_dtype is not None:
            self.model.set_compute_dtype(self.compute_dtype)
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model.set_dropout_generator(generator)
        return TrainState(model=self.model, opt=self.optimizer, dropout_generator=generator,
                          freeze=self.freeze)

    def run_epoch(self, state: TrainState, batches: Iterable[Dict[str, np.ndarray]],
                  epoch: int = 0, logger=None) -> Tuple[TrainState, Dict[str, float]]:
        last_metrics: Dict[str, torch.Tensor] = {}
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            lr = state.opt.current_lr()
            state, metrics = train_step(
                state, to_device(batch, self.device, self.compute_dtype), epoch,
                self.accumulate_grad_batches)
            if logger is not None and i % self.log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}  # the one sync
                host["lr"] = lr
                host["train_step_timing"] = (time.perf_counter() - t0) / (i + 1)
                logger.log_metrics(host, step=state.step)
            last_metrics = metrics
            for cb in self.callbacks:
                cb(state, metrics)
            if self.max_steps is not None and state.step >= self.max_steps:
                self.reached_max_steps = True
                break
        return state, {k: float(v) for k, v in last_metrics.items()}

    @torch.no_grad()
    def evaluate(self, state: TrainState, batches: Iterable[Dict[str, np.ndarray]],
                 epoch: int = 0) -> Dict[str, float]:
        """The task's metrics averaged over `batches`, in eval mode and
        without gradients; one sync at the end.  Under bf16 the forward runs
        in fp32 from the masters on the uncast batch, as the JAX trainer
        validates; the compute dtype is restored after."""
        module = state.model.module
        was_training = module.training
        module.eval()
        if self.compute_dtype is not None:
            state.model.set_compute_dtype(None)
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        try:
            for batch in batches:
                _, metrics = state.model.loss_fn(to_device(batch, self.device), epoch)
                for k, v in metrics.items():
                    totals[k] = totals[k] + v if k in totals else v
                n += 1
        finally:
            module.train(was_training)
            if self.compute_dtype is not None:
                state.model.set_compute_dtype(self.compute_dtype)
        return {k: float(v) / max(n, 1) for k, v in totals.items()}
